"""Ranks of the multi-process mesh tests (``test_torch_mesh_train.py``):
imported by each spawned process, so it imports torch and the port only.
Each rank joins a gloo group over a ``FileStore``, runs its mesh jobs,
and rank 0 writes every job's results to ``<out>/<job>.npz``: a train
job's losses and full final params, a serve job's prefill and decode
logits and final K/V cache."""
import os

import numpy as np
import torch
import torch.distributed as dist

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B, S = 4, 16


def tc(ckpt_dir, **kw):
    from repro_torch.runtime.trainer import TrainConfig
    base = dict(steps=3, log_every=100, ckpt_every=2, ckpt_dir=ckpt_dir,
                global_batch=B, seq_len=S)
    base.update(kw)
    return TrainConfig(**base)


def cfg_of(arch, **kw):
    import dataclasses
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32", **kw)


def train(arch, mesh, ckpt_dir, n_micro=1, **kw):
    """Losses and full final params of a 3-step run (``mesh``: a
    ``DeviceMesh``, a shape, or None for the plain path)."""
    from repro_torch.optim.adamw import OptConfig, tree_leaves_with_path
    from repro_torch.runtime.trainer import Trainer
    tr = Trainer(cfg_of(arch, **kw), tc(ckpt_dir, n_micro=n_micro), mesh,
                 OptConfig(**OPT), device="cpu")
    out = tr.run()
    params = {"/".join(p): (x.full_tensor() if hasattr(x, "full_tensor")
                            else x).detach().numpy()
              for p, x in tree_leaves_with_path(out["params"])}
    return [m["loss"] for m in tr.metrics_log], params, out["events"]


def _full(x):
    return (x.full_tensor() if hasattr(x, "full_tensor") else x).numpy()


def serve(arch, mesh):
    """A seeded prompt's prefill, then two decode steps, on the cast
    params (DTensors at the sharding rules' placements under ``mesh``,
    the cache at ``cache_shardings``'): the logits of each and the K/V
    cache after them."""
    from repro_torch.axes import mesh_of
    from repro_torch.launch import sharding as shd
    from repro_torch.models import lm
    cfg = cfg_of(arch)
    params = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, 12), generator=g)
    nxt = torch.randint(0, cfg.vocab, (B,), generator=g)
    if mesh is not None:
        params = shd.distribute(params, shd.param_shardings(cfg, params,
                                                            mesh))
        bs = shd.batch_spec(mesh, B)
        tokens = shd.distribute(tokens, shd.NamedSharding(mesh, bs + (None,)))
        nxt = shd.distribute(nxt, shd.NamedSharding(mesh, bs))
    leaf = params["final_norm"]["scale"]
    with torch.no_grad(), mesh_of(leaf):
        sp = lm.cast_params(cfg, params, "cpu")
        logits, cache = lm.prefill(cfg, sp, tokens, max_seq=16)
        if mesh is not None:
            cache = shd.distribute({k: _full_tensor(v) for k, v in
                                    cache.items()},
                                   shd.cache_shardings(cfg, cache, mesh))
        out = {"prefill": _full(logits)}
        for i in range(2):
            logits, cache = lm.decode_step(cfg, sp, nxt, cache)
            out[f"decode{i}"] = _full(logits)
        out.update(k=_full(cache["k"]), v=_full(cache["v"]))
    return out


def _full_tensor(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def run(rank, world, store, out, jobs):
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        for name, arch, shape, ckpt_dir, kw in jobs:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            if ckpt_dir is None:
                res = serve(arch, mesh)
            else:
                losses, params, events = train(arch, mesh, ckpt_dir, **kw)
                res = dict(params, __losses=np.array(losses),
                           __events=np.array("|".join(events)))
            if rank == 0:
                np.savez(os.path.join(out, f"{name}.npz"), **res)
            dist.barrier()
    finally:
        dist.destroy_process_group()
