"""The port's sharded training on the CPU: the DTensor ``Trainer`` on a
one-rank gloo (1, 1) mesh against JAX's ``Trainer`` on
``make_debug_mesh(1, 1)``; four spawned gloo ranks training reduced
qwen2.5-3b on a (2, 2) mesh and reduced olmoe-1b-7b on (1, 4) with
``moe_ep`` against the port's one-device runs; the re-mesh both ways (a
(2, 2) checkpoint finished on one device, a one-device checkpoint
finished on (2, 2)); and the errors of a mesh with no process group or
one of another size.

Every run computes in f32 from the same init (the port's, or JAX's
saved as a step-0 checkpoint) on the same prefetched batches. The gate
is the training gate: each step's loss within ``LOSS_TOL`` and every
param leaf within ``PARAM_TOL``; the sharded sums round in another order
than one device's, nothing else differs. The spawned ranks have a hard
deadline, so a hung collective fails the test instead of the run."""
import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_mesh_worker as worker
from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime import trainer as jtrainer
from repro_torch.launch import mesh as tmesh
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime import trainer as ttrainer

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
SERVE_TOL = 1e-4       # f32 logits and K/V, sharded sums in another order
DEADLINE_S = 180


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo process group over a ``FileStore``, destroyed
    after the test."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _assert_run_close(got, want, what):
    (gl, gp), (wl, wp) = got, want
    np.testing.assert_allclose(gl, wl, rtol=0, atol=LOSS_TOL,
                               err_msg=f"{what}: losses")
    assert sorted(gp) == sorted(wp)
    for name in wp:
        err = np.abs(gp[name].astype(np.float64) - wp[name]).max()
        assert err <= PARAM_TOL, f"{what} {name}: max |diff| {err}"


def _load(path):
    with np.load(path) as z:
        params = {k: z[k] for k in z.files if not k.startswith("__")}
        return list(z["__losses"]), params, str(z["__events"])


def _jax_debug_mesh():
    """JAX's ``make_debug_mesh(1, 1)`` with Auto axes: this jax makes
    Explicit axes by default, under which the JAX package's own gathers
    raise (its Trainer fails on the default mesh at its first step)."""
    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=auto)


def test_dtensor_trainer_on_one_rank_matches_jax_trainer(tmp_path,
                                                         one_rank_group):
    """Reduced qwen2.5-3b, 3 steps from JAX's init: the port's DTensor
    path on a one-rank (1, 1) mesh against JAX's ``Trainer`` on its
    (1, 1) debug mesh, step by step."""
    jc = jget_config("qwen2.5-3b").reduced()
    import dataclasses
    jc = dataclasses.replace(jc, compute_dtype="float32")
    jp = jax.tree.map(np.asarray, jlm.init_params(jc, jax.random.key(0),
                                                  max_seq=worker.S))
    dirs = [str(tmp_path / d) for d in ("jax", "port")]
    for d in dirs:
        jckpt.save(0, {"params": jp, "opt": jadamw.adamw_init(jp)}, d)
    jtc = jtrainer.TrainConfig(steps=3, log_every=100, ckpt_every=0,
                               ckpt_dir=dirs[0], global_batch=worker.B,
                               seq_len=worker.S)
    jt = jtrainer.Trainer(jc, jtc, _jax_debug_mesh(),
                          jadamw.OptConfig(**worker.OPT))
    jt.run()
    mesh = tmesh.make_debug_mesh(1, 1, device="cpu")
    tr = ttrainer.Trainer(worker.cfg_of("qwen2.5-3b"),
                          worker.tc(dirs[1], ckpt_every=0), mesh,
                          OptConfig(**worker.OPT), device="cpu")
    out = tr.run()
    assert out["events"] == ["restored step 0"]
    assert hasattr(out["params"]["embed"]["banks"], "placements")
    np.testing.assert_allclose([m["loss"] for m in tr.metrics_log],
                               [m["loss"] for m in jt.metrics_log],
                               rtol=0, atol=LOSS_TOL)


def _spawn(world, out, jobs):
    """Run ``worker.run`` on ``world`` ranks; fail on the deadline."""
    ctx = mp.start_processes(worker.run, args=(world, str(out / "store"),
                                               str(out), jobs),
                             nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                pytest.fail(f"mesh ranks still running after {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def test_four_ranks_train_equal_one_device_and_remesh_both_ways(tmp_path):
    """One spawn of four gloo ranks: reduced qwen2.5-3b on (2, 2) (also
    with two microbatches) and reduced olmoe-1b-7b on (1, 4) under
    ``moe_ep`` equal the port's one-device runs; a one-device checkpoint at step 2 finishes on
    (2, 2), and the (2, 2) run's step-2 checkpoint finishes on one
    device, both equal to the uninterrupted run. Serving on the mesh
    (prefill, two decode steps over the ring cache) equals one device's
    with the cache's kv heads sharded (qwen, (2, 2)) and its slots
    sharded (granite's two kv heads on a 4-way model axis), and with a
    MoE decode group spanning the batch shards (olmoe, (2, 2))."""
    d = lambda name: str(tmp_path / name)
    plain_q = worker.train("qwen2.5-3b", None, d("plain_q"))
    plain_o = worker.train("olmoe-1b-7b", None, d("plain_o"), moe_ep=True)
    assert os.listdir(d("plain_q")) == ["step_000000002"]
    shutil.copytree(d("plain_q"), d("to_mesh"))
    jobs = [("qwen_2x2", "qwen2.5-3b", (2, 2), d("mesh_q"), {}),
            ("olmoe_1x4", "olmoe-1b-7b", (1, 4), d("mesh_o"),
             {"moe_ep": True}),
            ("remesh_in", "qwen2.5-3b", (2, 2), d("to_mesh"), {}),
            ("micro_2x2", "qwen2.5-3b", (2, 2), d("mesh_m"),
             {"n_micro": 2}),
            ("serve_heads", "qwen2.5-3b", (2, 2), None, {}),
            ("serve_seq", "granite-20b", (1, 4), None, {}),
            ("serve_moe", "olmoe-1b-7b", (2, 2), None, {})]
    _spawn(4, tmp_path, jobs)
    for name, arch in (("serve_heads", "qwen2.5-3b"),
                       ("serve_seq", "granite-20b"),
                       ("serve_moe", "olmoe-1b-7b")):
        want = worker.serve(arch, None)
        with np.load(tmp_path / f"{name}.npz") as got:
            for key, w in want.items():
                np.testing.assert_allclose(got[key], w, rtol=0,
                                           atol=SERVE_TOL,
                                           err_msg=f"{name} {key}")
    q = _load(tmp_path / "qwen_2x2.npz")
    _assert_run_close(q[:2], plain_q[:2], "qwen (2, 2)")
    _assert_run_close(_load(tmp_path / "olmoe_1x4.npz")[:2], plain_o[:2],
                      "olmoe (1, 4) moe_ep")
    _assert_run_close(_load(tmp_path / "micro_2x2.npz")[:2],
                      worker.train("qwen2.5-3b", None, d("plain_m"),
                                   n_micro=2)[:2], "qwen (2, 2) n_micro 2")
    remesh_in = _load(tmp_path / "remesh_in.npz")
    assert remesh_in[2] == "restored step 2"
    _assert_run_close(remesh_in[:2], (plain_q[0][2:], plain_q[1]),
                      "one device -> (2, 2)")
    assert os.listdir(d("mesh_q")) == ["step_000000002"]
    shutil.rmtree(os.path.join(d("plain_q")))
    shutil.copytree(d("mesh_q"), d("from_mesh"))
    losses, params, events = worker.train("qwen2.5-3b", None, d("from_mesh"))
    assert events == ["restored step 2"]
    _assert_run_close((losses, params), (plain_q[0][2:], plain_q[1]),
                      "(2, 2) -> one device")


def test_mesh_without_group_or_of_another_size_raises(tmp_path):
    """No single-device fallback: a mesh above one device needs a process
    group, and one whose world size is the mesh's."""
    cfg = worker.cfg_of("qwen2.5-3b")
    with pytest.raises(ValueError, match="process group"):
        ttrainer.Trainer(cfg, worker.tc(str(tmp_path)), (2, 2), device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="4 devices.*world size is 1"):
            ttrainer.Trainer(cfg, worker.tc(str(tmp_path)), (2, 2),
                             device="cpu")
        with pytest.raises(ValueError, match="world size is 1"):
            tmesh.make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()
