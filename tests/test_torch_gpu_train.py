"""The training slice on the card against the CPU.

Every test here needs a CUDA card; without one it skips (decided inside
the ``cuda`` fixture, never at import). Run on the card:

    CUBLAS_WORKSPACE_CONFIG=:4096:8 python -m pytest -q --noconftest \
        -m gpu tests/test_torch_gpu_train.py

(``--noconftest``: the repo's conftest imports JAX, which the card's
machine does not have.) Deterministic algorithms are turned on by the
``deterministic`` fixture and off again after each test; cuBLAS reads
``CUBLAS_WORKSPACE_CONFIG`` once, before its first call, so the command
sets it (this module only fills it in when it is missing).

Tolerances: the coded lookup's forward and f32 backward card = CPU bit
for bit; a reduced ``Trainer`` run restored after a fault equals the
uninterrupted card run bit for bit; 3 f32 steps of ``make_train_step``
card against CPU (TF32 off): loss and grad norm to ``LOSS_TOL``, params
to 0.05 x the summed learning rates (see ``tests/test_torch_train.py``);
one f32 step of each non-dense family (phi-3-vision's batch with patch
embeddings, whisper's with frames; TF32 off, deterministic algorithms
not needed): loss and grad norm to ``LOSS_TOL``, both moments within
1e-4 of each leaf's largest magnitude, each param within 1e-4 of its
leaf's largest magnitude where the gradient is clear of Adam's eps, else
within lr (see ``tests/test_torch_train_families.py``).
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import embedding as emb
from repro_torch.models import lm
from repro_torch.optim.adamw import (OptConfig, adamw_init, cosine_schedule,
                                     tree_leaves, tree_leaves_with_path,
                                     tree_map)
from repro_torch.runtime import steps
from repro_torch.runtime.trainer import FaultPlan, TrainConfig, Trainer

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

pytestmark = pytest.mark.gpu

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with -m gpu on the card")
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.use_deterministic_algorithms(was)
    torch.backends.cuda.matmul.allow_tf32 = tf32


def test_coded_lookup_backward_card_equals_cpu(cuda, deterministic):
    """Forward and backward (duplicate tokens accumulating in f32) at
    qwen's bank count, card = CPU bit for bit."""
    rng = np.random.default_rng(1)
    banks = torch.from_numpy(rng.normal(size=(8, 64, 128)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, 100, (4, 256)))
    g = torch.from_numpy(rng.normal(size=(4, 256, 128)).astype(np.float32))
    outs = []
    for dev in (cuda, "cpu"):
        b = banks.to(dev).requires_grad_(True)
        out = emb.coded_lookup(b, toks.to(dev))
        out.backward(g.to(dev))
        outs.append((out.detach().cpu(), b.grad.cpu()))
    (o1, g1), (o2, g2) = outs
    assert torch.equal(o1.view(torch.int32), o2.view(torch.int32))
    assert torch.equal(g1.view(torch.int32), g2.view(torch.int32))


def test_reduced_trainer_restores_bit_identically(cuda, deterministic,
                                                  tmp_path):
    """A fault at step 3 with a checkpoint every 2 steps restores step 2 on
    the card and ends bit-identical to the uninterrupted card run."""
    cfg = get_config("qwen2.5-3b").reduced()
    outs = []
    for name, plan in (("a", None), ("b", FaultPlan([3]))):
        tc = TrainConfig(steps=6, log_every=100, ckpt_every=2,
                         ckpt_dir=str(tmp_path / name), global_batch=4,
                         seq_len=32)
        outs.append(Trainer(cfg, tc, opt_cfg=OptConfig(**OPT),
                            device=cuda).run(fault_plan=plan))
    a, b = outs
    assert "restored step 2" in b["events"]
    for x, y in zip(tree_leaves(a["params"]) + tree_leaves(a["opt"].m)
                    + tree_leaves(a["opt"].v),
                    tree_leaves(b["params"]) + tree_leaves(b["opt"].m)
                    + tree_leaves(b["opt"].v)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch,policy,q_chunk", [
    ("qwen2.5-3b", "full", 0), ("granite-20b", "full", 0),
    ("qwen2.5-3b", "dots", 16)])
def test_train_step_card_equals_cpu(cuda, deterministic, arch, policy,
                                    q_chunk):
    """3 f32 steps card = CPU; the "dots" case also streams the queries
    in chunks of 16."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32", remat_policy=policy)
    init = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    dcfg = DataConfig(vocab=cfg.vocab, batch=4, seq_len=32)
    runs = []
    for dev in (cuda, "cpu"):
        p = tree_map(lambda a: a.to(dev, copy=True), init)
        st = adamw_init(p)
        step = steps.make_train_step(cfg, OptConfig(**OPT), q_chunk=q_chunk)
        ms = []
        for s in range(3):
            toks = torch.from_numpy(make_batch(dcfg, s)["tokens"]).to(dev)
            p, st, m = step(p, st, {"tokens": toks})
            ms.append({k: float(v) for k, v in m.items()})
        runs.append((p, ms))
    (pc, mc), (pp, mp) = runs
    for a, b in zip(mc, mp):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], **LOSS_TOL)
    tol = 0.05 * sum(float(cosine_schedule(OptConfig(**OPT), s))
                     for s in range(1, 4))
    for x, y in zip(tree_leaves(pc), tree_leaves(pp)):
        assert (x.detach().cpu() - y.detach()).abs().max() <= tol


FAMILIES = ("olmoe-1b-7b", "mixtral-8x7b", "phi-3-vision-4.2b",
            "mamba2-2.7b", "recurrentgemma-9b", "whisper-tiny")


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_card_equals_cpu(cuda, arch):
    """One f32 step of a non-dense family, card = CPU (the module
    docstring has the tolerances)."""
    import dataclasses
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    init = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32,
                          max_seq=32)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 32), generator=gen)}
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.randn(4, cfg.n_patches, cfg.d_model,
                                       generator=gen)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(4, cfg.enc_frames, cfg.d_model,
                                      generator=gen)
    runs = []
    try:
        for dev in (cuda, "cpu"):
            p = tree_map(lambda a: a.to(dev, copy=True), init)
            step = steps.make_train_step(cfg, OptConfig(**OPT))
            p, st, m = step(p, adamw_init(p),
                            {k: v.to(dev) for k, v in batch.items()})
            runs.append((p, st, {k: float(v) for k, v in m.items()}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (pc, sc, mc), (pp, sp, mp) = runs
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(mc[k], mp[k], **LOSS_TOL)
    b1 = OptConfig().b1

    def named(tree, to_cpu):
        return {"/".join(k): (t.detach().cpu() if to_cpu else t.detach())
                .numpy() for k, t in tree_leaves_with_path(tree)}

    card = [named(t, True) for t in (pc, sc.m, sc.v)]
    cpu = [named(t, False) for t in (pp, sp.m, sp.v)]
    for name, x in cpu[0].items():
        for mom in (1, 2):
            scale = np.abs(cpu[mom][name]).max()
            if cfg.pos != "rope" and name.endswith("attn/bk"):
                # softmax cancels this gradient: rounding only
                scale = np.abs(cpu[mom][name[:-2] + "wk"]).max()
            err = np.abs(card[mom][name] - cpu[mom][name]).max()
            assert err <= 1e-4 * scale, (name, mom, err)
        diff = np.abs(card[0][name] - x)
        clear = np.abs(cpu[1][name]) / (1 - b1) >= 1e-6
        assert diff[clear].max(initial=0) <= 1e-4 * np.abs(x).max(), name
        assert diff.max() <= OPT["lr"], name


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_nccl_one_rank_mesh_trainer_equals_plain(cuda, tmp_path):
    """Reduced qwen2.5-3b, 3 steps, on a one-rank NCCL process group and a
    (1, 1) ("data", "model") ``DeviceMesh``: the DTensor ``Trainer``'s
    losses within 1e-5 and params within 1e-4 of the plain ``Trainer``
    from the same seed (on a one-device mesh every op takes its plain
    formulation, so they are expected bit for bit)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh

    cfg = get_config("qwen2.5-3b").reduced()

    def run(mesh, d):
        tc = TrainConfig(steps=3, log_every=100, ckpt_every=0,
                         ckpt_dir=str(tmp_path / d), global_batch=4,
                         seq_len=32)
        tr = Trainer(cfg, tc, mesh, OptConfig(**OPT), device="cuda")
        out = tr.run()
        params = {"/".join(p): (x.full_tensor() if hasattr(x, "full_tensor")
                                else x).detach().cpu()
                  for p, x in tree_leaves_with_path(out["params"])}
        return [m["loss"] for m in tr.metrics_log], params

    plain = run(None, "plain")
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = run(make_debug_mesh(1, 1, device="cuda"), "mesh")
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(mesh[0], plain[0], rtol=0, atol=1e-5)
    for name, x in plain[1].items():
        assert float((mesh[1][name].float() - x.float()).abs().max()) \
            <= 1e-4, name
