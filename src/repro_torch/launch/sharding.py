"""Path+shape-driven sharding rules (``repro.launch.sharding``
counterpart): FSDP over ``data`` x TP over ``model``; ``pod`` is outer
data parallelism.

A spec is JAX's ``PartitionSpec`` as a plain tuple, one entry per tensor
dim: a mesh-axis name, a tuple of names, or None. ``to_placements``
turns it into DTensor placements, one per MESH dim: ``Shard(d)`` where
``spec[d]`` names that mesh dim (of more than one device), else
``Replicate()``. A composite
``("pod", "data")`` on one tensor dim shards it over both mesh dims in
mesh-dim order, which is JAX's major-to-minor order (``pod`` precedes
``data`` in the mesh).

Divisibility-aware: every rule passes through ``_fits``, which falls
back to replication on a dim its axes do not divide, so no shard is ever
uneven. ``describe`` prints the chosen specs so a lost sharding
opportunity is visible rather than silent.

TP convention: column-parallel for up-projections (out dim on
``model``), row-parallel for down-projections (in dim on ``model``).
Embedding tables shard their vocab dim on ``model`` (the coded bank
axis); the lookup is a masked partial gather on each model rank and an
all-reduce (``models/embedding.py``), never an all-gather of the table.

Leaf names are the '/'-joined key paths JAX's ``_path_str`` gives: the
port's param tree has JAX's nesting and names (``convert.py``), and a
NamedTuple cache's fields are named as JAX names them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

from repro_torch.axes import axis_names, mesh_shape
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import batch_axes

Spec = tuple


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``); ``placements`` are its
    DTensor placements. A leaf of the trees it fills, not a node."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of a per-tensor-dim spec. A
    mesh dim of one device splits nothing, so it replicates: the same
    layout, and every op keeps its plain strategy there."""
    from torch.distributed.tensor import Replicate, Shard
    names, sizes = axis_names(mesh), mesh_shape(mesh)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None and sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        return math.prod(shape[a] for a in axis)
    return shape[axis]


def _fits(dim: int, mesh, axis) -> Optional[Any]:
    return _norm(axis) if (axis is not None
                           and dim % _axis_size(mesh, axis) == 0) else None


def _norm(axis):
    """A one-axis tuple as its name, as JAX's ``PartitionSpec`` stores
    it."""
    return axis[0] if isinstance(axis, tuple) and len(axis) == 1 else axis


def flatten_with_path(tree: Any, path: str = ""):
    """(path, leaf) of every leaf of nested dicts and NamedTuples, paths
    '/'-joined as JAX's ``_path_str`` joins them."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                flatten_with_path(tree[k], f"{path}/{k}" if path else k)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for k, v in zip(tree._fields, tree) for kv in
                flatten_with_path(v, f"{path}/{k}" if path else k)]
    return [(path, tree)]


def map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                  path: str = "") -> Any:
    """``tree`` with each leaf ``x`` at ``path`` replaced by ``fn(path,
    x)`` (None leaves kept)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, f"{path}/{k}" if path
                                          else k)
                            for k, v in zip(tree._fields, tree)))
    return None if tree is None else fn(path, tree)


# --------------------------------------------------------------------- params
def param_spec(name: str, shape, mesh, *, fsdp: bool = True,
               moe_ep: bool = False) -> Spec:
    """The spec of one parameter leaf. ``name`` is the '/'-joined key
    path; stacked per-layer leaves carry a leading L dim which is never
    sharded, so unbinding the layers stays local."""
    names = axis_names(mesh)
    d_ax = "data" if (fsdp and "data" in names) else None
    m_ax = "model" if "model" in names else None
    nd = len(shape)
    spec = [None] * nd
    leaf = name.rsplit("/", 1)[-1]

    if nd <= 1 or m_ax is None:
        return tuple(spec)

    stacked = name.startswith(("blocks", "rec_blocks", "attn_blocks",
                               "enc_blocks"))
    lo = 1 if stacked else 0          # first shardable dim
    if nd - lo < 1:
        return tuple(spec)

    if leaf == "table":               # embed (Vp, D): vocab = coded bank axis
        spec[0] = _fits(shape[0], mesh, m_ax)
        return tuple(spec)            # D replicated: no data-axis
                                      # contraction against batch-on-data
    if leaf == "banks":               # coded embed (NB, Vb, D)
        spec[1] = _fits(shape[1], mesh, m_ax)
        return tuple(spec)
    if leaf == "lm_head":             # (D, Vp)
        spec[1] = _fits(shape[1], mesh, m_ax)
        return tuple(spec)
    if leaf == "pos_embed":           # (S, D)
        spec[1] = _fits(shape[1], mesh, m_ax)
        return tuple(spec)

    if nd - lo < 2:                   # stacked vectors (norms, biases, gates)
        return tuple(spec)

    row_parallel = leaf in ("w_down", "wo", "out_proj", "w_out")
    if leaf in ("w_up", "w_gate", "w_down") and nd - lo == 3:  # MoE (E,D,F)
        if moe_ep:                    # expert parallelism: E over `model`
            spec[nd - 3] = _fits(shape[nd - 3], mesh, m_ax)
            return tuple(spec)
        i, o = (nd - 1, nd - 2) if row_parallel else (nd - 2, nd - 1)
        spec[o] = _fits(shape[o], mesh, m_ax)
        spec[i] = _fits(shape[i], mesh, d_ax)
        return tuple(spec)

    i, o = (nd - 2, nd - 1)
    if row_parallel:
        spec[i] = _fits(shape[i], mesh, m_ax)
        spec[o] = _fits(shape[o], mesh, d_ax)
    else:                             # column-parallel (wq/wk/wv/w_up/...)
        spec[o] = _fits(shape[o], mesh, m_ax)
        spec[i] = _fits(shape[i], mesh, d_ax)
    return tuple(spec)


def param_shardings(cfg: ModelConfig, params: Any, mesh, *,
                    fsdp: bool = True) -> Any:
    """A ``NamedSharding`` per leaf of ``params`` (tensors of any device,
    ``meta`` included)."""
    return map_with_path(lambda name, leaf: NamedSharding(
        mesh, param_spec(name, tuple(leaf.shape), mesh, fsdp=fsdp,
                         moe_ep=cfg.moe_ep)), params)


# ---------------------------------------------------------------- opt state
def opt_shardings(param_sh: Any, mesh) -> Any:
    """Adam moments shard exactly like their parameters; the step is a
    host scalar (None: not distributed)."""
    from repro_torch.optim.adamw import OptState
    return OptState(step=None, m=param_sh, v=param_sh)


# ------------------------------------------------------------------- inputs
def batch_spec(mesh, batch_size: int) -> Spec:
    """The global-batch dim over (pod, data); replicated if indivisible
    (long_500k has batch 1)."""
    axes = batch_axes(mesh)
    if axes and batch_size % _axis_size(mesh, axes) == 0:
        return (_norm(axes),)
    return (None,)


def data_shardings(mesh, batch: Any) -> Any:
    """A host batch dict's shardings: dim 0 the global batch, the rest
    replicated."""
    return map_with_path(lambda _, x: NamedSharding(
        mesh, batch_spec(mesh, x.shape[0]) + (None,) * (x.ndim - 1)),
        batch)


def cache_shardings(cfg: ModelConfig, cache: Any, mesh, *,
                    kv_variant: str = "auto") -> Any:
    """KV/state cache: the batch dim over (pod, data); for KV leaves heads
    on ``model`` where they divide, else the cache-seq dim (context
    parallelism: granite, kv=1, cannot shard heads).

    ``kv_variant``:
      auto         — heads on model if divisible, else cache-seq
      batch_model  — the KV batch dim over (pod|data) x model
    """
    baxes = batch_axes(mesh)
    m_ax = "model" if "model" in axis_names(mesh) else None

    def one(name, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if name == "pos":
            spec[0] = _fits(shape[0], mesh, baxes if baxes else None)
            return NamedSharding(mesh, tuple(spec))
        # stacked leaves (L, B, ...): kv (L,B,C,Hkv,hd); ssm conv
        # (L,B,K-1,C), state (L,B,H,P,N); rg conv (L,B,K-1,dr), h (L,B,dr)
        if name in ("k", "v", "xk", "xv") and nd == 5:
            if kv_variant == "batch_model":
                all_ax = tuple(baxes) + ((m_ax,) if m_ax else ())
                spec[1] = _fits(shape[1], mesh, all_ax)
                if spec[1] is None:
                    spec[1] = _fits(shape[1], mesh, m_ax)
                return NamedSharding(mesh, tuple(spec))
            spec[1] = _fits(shape[1], mesh, baxes if baxes else None)
            if _fits(shape[3], mesh, m_ax):
                spec[3] = m_ax                      # heads
            else:
                spec[2] = _fits(shape[2], mesh, m_ax)  # cache seq (CP)
            return NamedSharding(mesh, tuple(spec))
        if nd >= 2:
            spec[1] = _fits(shape[1], mesh, baxes if baxes else None)
        if nd >= 3:
            # the last dim is a width (channels / state)
            spec[nd - 1] = _fits(shape[nd - 1], mesh, m_ax)
        return NamedSharding(mesh, tuple(spec))

    return map_with_path(one, cache)


def describe(shardings: Any) -> str:
    return "\n".join(f"  {name:50s} {sh.spec}"
                     for name, sh in flatten_with_path(shardings)
                     if sh is not None)


# ------------------------------------------------------------ distribution
def distribute(tree: Any, shardings: Any) -> Any:
    """Each tensor leaf of ``tree`` (full, on the mesh's device or
    ``meta``) as a DTensor at its ``NamedSharding``; None shardings leave
    their leaf as it is. Every rank holds the same full leaf (the same
    seeded init, checkpoint or batch), so each keeps its own shard and
    nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, sh):
        if sh is None:
            return x
        return distribute_tensor(x, sh.mesh, sh.placements,
                                 src_data_rank=None)

    return zip_map(one, tree, shardings)


def zip_map(fn: Callable, tree: Any, other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over two trees of the same structure
    (``other`` may hold None where ``tree`` has a leaf or a subtree)."""
    if other is None:
        return fn(tree, None) if not isinstance(tree, (dict, tuple)) \
            else tree
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(zip_map(fn, v, o) for v, o in zip(tree, other)))
    return fn(tree, other)


def local_nbytes(x) -> int:
    """Bytes of ``x``'s local shard (of ``x`` itself, for a plain
    tensor)."""
    t = x.to_local() if hasattr(x, "to_local") else x
    return t.numel() * t.element_size()


def local_shape(shape, spec: Spec, mesh) -> tuple:
    """A leaf's local shard shape under ``spec`` (every sharded dim
    divides: ``_fits``)."""
    return tuple(s // _axis_size(mesh, ax) for s, ax in zip(shape, spec))
