"""Multi-pod dry-run (``repro.launch.dryrun`` counterpart): run one step of
every (arch x shape x mesh) cell on ``meta`` DTensors and derive the
memory and roofline terms per device, with nothing allocated.

The cell runs in a process of its own under a ``"fake"`` process group
of the mesh's size (256 ranks for ``pod16x16``, 512 for ``pod2x16x16``),
so the port's real sharding path runs: the params, moments, batch and
cache are DTensors at ``launch.sharding``'s placements, and DTensor
plans every redistribution as it would on the devices. A dispatch mode
(``_Tally``) sees each op on the LOCAL shards (it steps aside for the
DTensor-level op, so the local ops and the collectives DTensor issues
come through it) and counts per device:

  * **memory pass** — the FULL config, one step: argument bytes are the
    summed local-shard bytes of params, moments and batch (or params,
    cache and token); the live peak is the most local bytes that op
    outputs held at once on top of them (``fits_hbm_80g``).
  * **cost pass (secant)** — JAX's probes: per-layer cost is measured at
    two (three for hybrid) small depths and extrapolated linearly in L,
    ``cost(L) = base + n_blocks(L)·per_block [+ n_rem·per_rem]``, exact
    because the layers cost the same (``tests/test_torch_launch.py``
    checks it against a full-depth count).

What the counts are, and are not:
  * FLOPs come from ``torch.utils.flop_counter``'s formulas, which count
    matmul-class ops (mm, bmm, addmm, baddbmm, attention, convolution);
    XLA's ``cost_analysis`` counts every op, so the figures compare with
    ``model_flops``, not with the JAX package's artefacts.
  * "Bytes" are the summed input and output bytes of every local op that
    makes a new tensor (views and in-place ops move nothing of their
    own): an unfused upper bound on the device's memory traffic.
  * Collective bytes are read from the ``_c10d_functional`` collectives'
    tensor sizes with JAX's ring factors (all-reduce 2x out,
    reduce-scatter 1x in, all-gather / all-to-all / permute 1x out).

Roofline constants: the NVIDIA H100 SXM5 80GB datasheet — 989.4 TFLOP/s
dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink per direction per GPU. The
mesh shapes and names are the JAX package's, so a record compares with
JAX's cell by cell; on H100s a 16-way ``model`` axis spans two 8-GPU
nodes, so the collective term at NVLink bandwidth is a lower bound.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.axes import mesh_of
from repro_torch.configs.base import ModelConfig, all_configs, get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD
from repro_torch.launch.shapes import (SHAPES, ShapeSpec, applicable,
                                       default_q_chunk, input_specs)
from repro_torch.models import lm
from repro_torch.optim.adamw import OptConfig, adamw_init
from repro_torch.runtime import steps as steps_mod

# --------------------------------------------------------------- HW constants
PEAK_FLOPS = 989.4e12      # H100 SXM5 80GB datasheet: dense bf16 tensor core
HBM_BW = 3.35e12           # bytes/s, H100 SXM5 HBM3
LINK_BW = 450e9            # bytes/s, NVLink 4 per direction per GPU
HBM_BYTES = 80e9

# ring-algorithm wire bytes per collective: (factor, read the input?)
_COLL = {
    "all_reduce": ("all-reduce", 2.0, False),
    "reduce_scatter_tensor": ("reduce-scatter", 1.0, True),
    "all_gather_into_tensor": ("all-gather", 1.0, False),
    "all_to_all_single": ("all-to-all", 1.0, False),
    "permute_tensor": ("collective-permute", 1.0, False),
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


class _Tally(TorchDispatchMode):
    """Per-device counts of the local ops of one step: FLOPs, op bytes,
    collective wire bytes by kind, and the live local bytes of the op
    outputs (tensors sharing a storage counted once, freed when the last
    of them is)."""

    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor, self._fake = DTensor, FakeTensor
        self._flops_of = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll: Dict[str, float] = {}
        self.coll_n: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}

    def _track(self, t: torch.Tensor):
        key = t.untyped_storage()._cdata
        ent = self._refs.get(key)
        if ent is None:
            ent = self._refs[key] = [0, t.untyped_storage().nbytes()]
            self.live += ent[1]
            self.peak = max(self.peak, self.live)
        ent[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key):
        ent = self._refs[key]
        ent[0] -= 1
        if ent[0] == 0:
            self.live -= ent[1]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented       # DTensor runs its local ops here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, self._fake) for t in types) or any(
                isinstance(t, self._fake) for t in _tensors(out)):
            return out                  # DTensor's global-shape planning
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional" and name in _COLL:
            kind, factor, read_in = _COLL[name]
            src = args[0] if read_in else out
            self.coll[kind] = self.coll.get(kind, 0.0) + factor * _nbytes(
                src)
            self.coll_n[kind] = self.coll_n.get(kind, 0) + 1
        elif packet in self._flops_of:
            self.flops += self._flops_of[packet](*args, **kwargs,
                                                 out_val=out)
        ins = list(_tensors((args, kwargs)))
        keys = {t.untyped_storage()._cdata for t in ins}
        outs = [t for t in _tensors(out)
                if t.untyped_storage()._cdata not in keys]   # not views
        if outs:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out

    def coll_bytes(self) -> float:
        return float(sum(self.coll.values()))


# ------------------------------------------------------------------- process
def _fake_group(world: int) -> None:
    """A ``"fake"`` process group of ``world`` ranks in this process (rank
    0's view), replacing any other."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(multi_pod: bool = False):
    """The production mesh on ``cpu`` over a fake group of its size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = MULTI_POD if multi_pod else SINGLE_POD
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    _fake_group(n)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


# ------------------------------------------------------------------ lowering
def lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               q_chunk: Optional[int] = None, fsdp: bool = True,
               remat: bool = True, n_micro: int = 1,
               kv_variant: str = "auto"):
    """(step, args): the cell's step function and its arguments, meta
    DTensors at the sharding rules' placements on ``mesh``. Prefill and
    decode take the master params and cast them in the step, as JAX's
    step functions do."""
    if q_chunk is None:
        q_chunk = default_q_chunk(cfg, shape)
    params = lm.abstract_params(cfg, max_seq=shape.seq_len)
    params = shd.distribute(params, shd.param_shardings(cfg, params, mesh,
                                                        fsdp=fsdp))
    specs = input_specs(cfg, shape)
    leaf = next(x for _, x in shd.flatten_with_path(params))

    def cast(p):
        return lm.cast_params(cfg, p, torch.device("meta"))

    if shape.kind == "train":
        step = steps_mod.make_train_step(cfg, OptConfig(), remat=remat,
                                         q_chunk=q_chunk, n_micro=n_micro)
        batch = shd.distribute(specs["batch"],
                               shd.data_shardings(mesh, specs["batch"]))
        return step, (params, adamw_init(params), batch)
    if shape.kind == "prefill":
        pre = steps_mod.make_prefill_step(cfg, q_chunk=q_chunk)
        batch = shd.distribute(specs["batch"],
                               shd.data_shardings(mesh, specs["batch"]))

        def prefill_step(p, b):
            with mesh_of(leaf):
                return pre(cast(p), b["tokens"], patches=b.get("patches"),
                           frames=b.get("frames"))

        return prefill_step, (params, batch)
    serve = steps_mod.make_serve_step(cfg)
    cache = shd.distribute(specs["cache"], shd.cache_shardings(
        cfg, specs["cache"], mesh, kv_variant=kv_variant))
    token = shd.distribute(specs["token"], shd.NamedSharding(
        mesh, shd.batch_spec(mesh, shape.global_batch)))

    def serve_step(p, t, c):
        with mesh_of(leaf):
            return serve(cast(p), t, c)

    return serve_step, (params, token, cache)


def argument_bytes(args) -> int:
    """Summed local-shard bytes of a cell's arguments."""
    return sum(shd.local_nbytes(x) for _, x in shd.flatten_with_path(
        {str(i): a for i, a in enumerate(args)})
        if isinstance(x, torch.Tensor))


def run_step(step, args) -> _Tally:
    """One step under the tally."""
    with _Tally() as tally:
        out = step(*args)
        del out
    return tally


# ----------------------------------------------------------- secant cost fit
def _probe_layers(cfg: ModelConfig):
    if cfg.family == "hybrid":
        return (2, 3, 6)
    return (1, 2)


def _with_layers(cfg: ModelConfig, L: int) -> ModelConfig:
    return dataclasses.replace(cfg, name=f"{cfg.name}-probe{L}", n_layers=L)


def _reconstruct(cfg: ModelConfig, costs: Dict[int, float]) -> float:
    """Extrapolate a linear-in-depth cost to the full layer count."""
    if cfg.family == "hybrid":
        c2, c3, c6 = costs[2], costs[3], costs[6]
        sb = c6 - c3                      # per (rec,rec,attn) superblock
        base = c3 - sb
        rl = (c2 - base) / 2.0            # per remainder rec layer
        n_super, n_rem, _ = lm.hybrid_layout(cfg)
        return base + n_super * sb + n_rem * rl
    c1, c2 = costs[1], costs[2]
    pl = c2 - c1
    return c1 + (cfg.n_layers - 1) * pl


def cost_pass(cfg: ModelConfig, shape: ShapeSpec, mesh, *, fsdp: bool = True,
              remat: bool = True, q_chunk: Optional[int] = None,
              n_micro: int = 1, kv_variant: str = "auto") -> Dict[str, Any]:
    """Secant-extrapolated flops / bytes / collective bytes per device."""
    metrics: Dict[int, Dict[str, float]] = {}
    for L in _probe_layers(cfg):
        step, args = lower_cell(_with_layers(cfg, L), shape, mesh,
                                q_chunk=q_chunk, fsdp=fsdp, remat=remat,
                                n_micro=n_micro, kv_variant=kv_variant)
        t = run_step(step, args)
        metrics[L] = {"flops": float(t.flops), "bytes": float(t.bytes),
                      "coll_bytes": t.coll_bytes()}
        del step, args
    out: Dict[str, Any] = {}
    for key in ("flops", "bytes", "coll_bytes"):
        out[key] = max(_reconstruct(cfg, {L: m[key] for L, m in
                                          metrics.items()}), 0.0)
    out["probes"] = {str(L): m for L, m in metrics.items()}
    return out


# --------------------------------------------------------------------- cells
def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train (N = active params), 2·N·B
    decode."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one token per sequence


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: Optional[str] = None, fsdp: bool = True,
             remat: bool = True, q_chunk: Optional[int] = None,
             n_micro: int = 1, skip_cost: bool = False,
             tag: str = "", kv_variant: str = "auto",
             cfg_overrides: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "multi_pod": multi_pod, "fsdp": fsdp, "n_micro": n_micro, "tag": tag,
    }
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        _emit(rec, out_dir)
        return rec

    mesh = make_mesh(multi_pod)
    n_chips = mesh.size()
    kw = dict(q_chunk=q_chunk, fsdp=fsdp, remat=remat, n_micro=n_micro,
              kv_variant=kv_variant)
    t0 = time.time()
    step, args = lower_cell(cfg, shape, mesh, **kw)
    arg_b = argument_bytes(args)
    tally = run_step(step, args)
    del step, args
    rec["compile_s"] = round(time.time() - t0, 1)
    rec["memory"] = {
        "argument_bytes": int(arg_b),
        "temp_bytes": int(tally.peak),
        "peak_bytes": int(arg_b + tally.peak),
        "live_bytes": int(arg_b + tally.peak),
    }
    rec["fits_hbm_80g"] = bool(arg_b + tally.peak < HBM_BYTES)
    rec["full_pass"] = {
        "flops": float(tally.flops), "bytes": float(tally.bytes),
        "coll_bytes": tally.coll_bytes(), "coll_counts": dict(tally.coll_n),
        "coll_bytes_by_kind": dict(tally.coll),
    }

    if not skip_cost:
        cost = cost_pass(cfg, shape, mesh, **kw)
        rec["cost"] = cost
        mf = model_flops(cfg, shape)
        fl_dev, by_dev, cb_dev = cost["flops"], cost["bytes"], \
            cost["coll_bytes"]
        t_comp = fl_dev / PEAK_FLOPS
        t_mem = by_dev / HBM_BW
        t_coll = cb_dev / LINK_BW
        dom = max((t_comp, "compute"), (t_mem, "memory"),
                  (t_coll, "collective"))
        bound = max(t_comp, t_mem, t_coll)
        rec["roofline"] = {
            "chips": n_chips,
            "flops_per_dev": fl_dev,
            "bytes_per_dev": by_dev,
            "coll_bytes_per_dev": cb_dev,
            "t_compute_s": t_comp,
            "t_memory_s": t_mem,
            "t_collective_s": t_coll,
            "dominant": dom[1],
            "bound_s": bound,
            "model_flops_total": mf,
            "model_flops_per_dev": mf / n_chips,
            "useful_flops_ratio": (mf / n_chips) / fl_dev if fl_dev else 0.0,
            "roofline_frac": (mf / n_chips / PEAK_FLOPS) / bound
                             if bound > 0 else 0.0,
        }
    rec["status"] = "ok"
    _emit(rec, out_dir)
    return rec


def _emit(rec: Dict[str, Any], out_dir: Optional[str]):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{rec['tag']}" if rec.get("tag") else ""
        path = os.path.join(
            out_dir, f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    if rec.get("status") == "skipped":
        print(f"[dryrun] {rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:10s} "
              f"SKIP ({rec['reason'][:60]})")
    else:
        r = rec.get("roofline", {})
        print(f"[dryrun] {rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:10s} "
              f"OK trace={rec.get('compile_s')}s "
              f"peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB "
              f"dom={r.get('dominant', '-'):10s} "
              f"frac={r.get('roofline_frac', 0):.3f}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/torch/dryrun")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=None)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--skip-cost", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--moe-ep", action="store_true")
    ap.add_argument("--attn-bf16", action="store_true")
    ap.add_argument("--moe-group", type=int, default=0)
    ap.add_argument("--rg-scan-bf16", action="store_true")
    ap.add_argument("--remat-policy", default="full", choices=("full", "dots"))
    ap.add_argument("--kv-variant", default="auto",
                    choices=("auto", "batch_model"))
    args = ap.parse_args(argv)
    if args.attn_bf16:
        raise SystemExit("--attn-bf16: the port's attention keeps its AV "
                         "product in f32 (no attn_av_bf16 switch)")
    overrides: Dict[str, Any] = {}
    if args.moe_ep:
        overrides["moe_ep"] = True
    if args.moe_group:
        overrides["moe_group"] = args.moe_group
    if args.rg_scan_bf16:
        overrides["rg_scan_bf16"] = True
    if args.remat_policy != "full":
        overrides["remat_policy"] = args.remat_policy

    torch.set_num_threads(1)
    archs = sorted(all_configs()) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                             fsdp=not args.no_fsdp, remat=not args.no_remat,
                             q_chunk=args.q_chunk, n_micro=args.n_micro,
                             skip_cost=args.skip_cost, tag=args.tag,
                             kv_variant=args.kv_variant,
                             cfg_overrides=overrides or None)
                except Exception as e:  # noqa: BLE001 — report all cells
                    failures.append((arch, shape, mp, repr(e)[:200]))
                    print(f"[dryrun] {arch} {shape} mp={mp} FAIL: {e!r}"[:300])
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall cells OK")


if __name__ == "__main__":
    main()
