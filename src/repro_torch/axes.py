"""Logical activation-axis placements (``repro.axes`` counterpart).

The model code pins *logical* axes at a few points (``shard(x, "batch",
None, "vocab")``): after the embedding lookup, on the logits, and on the
MoE's expert axis under ``cfg.moe_ep``. The mapping from logical names
to the axes of a ``DeviceMesh`` lives here, and ``shard`` is the
identity outside a ``use_mesh`` context and on a plain tensor, so every
single-device path runs as it did.

Logical names:
  batch   -> ("pod", "data")     (whichever exist in the mesh)
  vocab / heads / ff / embed_row / width / experts -> "model"
  seq     -> "model"             (sequence/context parallelism, opt-in)

``shard`` is the counterpart of ``with_sharding_constraint``: it
redistributes a DTensor to the resolved placements, counted in
``REDISTRIBUTIONS`` (read by the trainer and ``chip_smoke.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)

_RULES = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "ff": ("model",),
    "width": ("model",),
    "embed_row": ("model",),
    "seq": ("model",),
    "experts": ("model",),
}

# redistributions that changed a DTensor's placements, by site
REDISTRIBUTIONS = {"n": 0}


def reset_redistributions() -> None:
    REDISTRIBUTIONS["n"] = 0


def redistribute(x, placements):
    """DTensor ``x`` at ``placements``: a counted redistribution where
    they differ from its own, ``x`` itself where they do not."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    REDISTRIBUTIONS["n"] += 1
    return x.redistribute(x.device_mesh, placements)


@contextlib.contextmanager
def use_mesh(mesh):
    tok = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(tok)


def current_mesh():
    return _MESH.get()


@contextlib.contextmanager
def mesh_of(x):
    """The mesh of DTensor ``x`` active (``use_mesh``), with plain tensors
    that meet DTensors counted as replicated (the model's constants: its
    masks, positions, index vectors); nothing for a plain tensor."""
    if not is_dtensor(x):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with use_mesh(x.device_mesh), implicit_replication():
        yield


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of anything with
    ``axis_names`` and a ``shape`` mapping, as JAX's mesh has)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, mesh.shape))


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _resolve(mesh, name: Optional[str], dim: int):
    """The mesh axis (or tuple of axes) for logical ``name`` on a dim of
    size ``dim``, or None: a composite rule that does not divide falls
    back to its first single axis that does."""
    if name is None:
        return None
    shape = mesh_shape(mesh)
    axes = tuple(a for a in _RULES[name] if a in shape)
    if not axes:
        return None
    size = math.prod(shape[a] for a in axes)
    if size <= 1 or dim % size != 0:
        for a in axes:
            if shape[a] > 1 and dim % shape[a] == 0:
                return a
        return None
    return axes if len(axes) > 1 else axes[0]


def shard(x, *names: Optional[str]):
    """Redistribute ``x`` so dim i is sharded per logical axis
    ``names[i]``, and its gradient likewise. Identity when no mesh is
    active or ``x`` is a plain tensor."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    if len(names) != x.ndim:
        raise ValueError(f"rank mismatch: {len(names)} names for {x.shape}")
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch.sharding import to_placements
    spec = tuple(_resolve(mesh, n, d) for n, d in zip(names, x.shape))
    want = to_placements(spec, x.device_mesh)
    return _Pin.apply(x, tuple(want))


class _Pin(torch.autograd.Function):
    """A redistribution whose gradient is pinned the same way, as JAX's
    ``with_sharding_constraint`` constrains the cotangent too: eager
    DTensor would otherwise hand the gradient back at whatever placements
    the backward ops left it."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        out = redistribute(x, want)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return redistribute(g, ctx.want), None


def gather_dim(x, dim: int):
    """DTensor ``x`` with tensor dim ``dim`` whole on every rank (its
    shards all-gathered, counted), the other placements kept; a plain
    tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    return redistribute(x, (Replicate() if isinstance(p, Shard)
                            and p.dim == dim else p for p in x.placements))


def fsdp_gather(w):
    """A DTensor weight with its shards over the batch axes (``pod``,
    ``data``: FSDP) all-gathered, the other placements kept; a plain
    tensor as it is. For the ops whose sharding DTensor would otherwise
    have to work out across a batch-sharded contraction."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names or ()
    return redistribute(w, (Replicate() if n in _RULES["batch"] else p
                            for n, p in zip(names, w.placements)))


def from_local(t: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` over ``t``, the local result of a
    region computed on shards (made contiguous, so the DTensor's strides
    are the global shape's row-major ones)."""
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(t.contiguous(), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def sharded(x, dim: int) -> bool:
    """Whether DTensor ``x`` splits tensor dim ``dim`` over a mesh dim of
    more than one device (a one-device mesh dim splits nothing, and the
    plain formulation of an op then runs, bit for bit as off the
    mesh)."""
    from torch.distributed.tensor import Shard
    dim %= x.ndim
    return any(isinstance(pl, Shard) and pl.dim == dim
               and x.device_mesh.size(m) > 1
               for m, pl in enumerate(x.placements))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing the distributed
    package for a plain tensor)."""
    return type(x) is not torch.Tensor and hasattr(x, "device_mesh") \
        and hasattr(x, "placements")
