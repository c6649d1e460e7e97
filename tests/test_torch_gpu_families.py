"""The MoE, vision-prefix, SSM, hybrid and audio families and the serving
report on the card against the CPU.

Every test here needs a CUDA card; without one it skips (decided inside
the ``cuda`` fixture, never at import). Run on the card:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu_families.py

(``--noconftest``: the repo's conftest imports JAX, which the card's
machine does not have.) Reduced olmoe-1b-7b (the coded pool), mixtral-8x7b
(the ring, window 16), phi-3-vision-4.2b (the ring, random patches),
mamba2-2.7b (the ring with SSM states), recurrentgemma-9b (the ring
with RG-LRU states, local window 16) and whisper-tiny (the ring with the
cross-attention K/V, seeded random frames) at f32 with TF32 off, from
one init drawn on the CPU: the served tokens are identical; the prefill
logits and the first decode step's agree within ``TOL``; a MoE block routes the same
logits alike on both devices and its output agrees within ``TOL`` of its
largest magnitude; ``serve_report`` passes its oracle gates on the card
with the CPU run's planes. The full-width one-layer MoE, SSM and RG-LRU
checks and full-width whisper-tiny are ``chip_smoke.py``'s cross phase.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.runtime import kvbank as kb
from repro_torch.runtime.server import Request, ServeConfig, Server

pytestmark = pytest.mark.gpu

TOL = 1e-4
FAMILIES = ("olmoe-1b-7b", "mixtral-8x7b", "phi-3-vision-4.2b",
            "mamba2-2.7b", "recurrentgemma-9b", "whisper-tiny")
SC = dict(n_slots=4, max_prompt=16, max_seq=64, max_new_tokens=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with -m gpu on the card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _cfg(name):
    return dataclasses.replace(get_config(name).reduced(), kv_page=4,
                               compute_dtype="float32")


def _reqs(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=[int(x) for x in rng.integers(
        1, vocab // 2, size=4 + i % 9)]) for i in range(n)]


def _patches(cfg, b, device):
    if cfg.frontend != "vision_stub":
        return None
    gen = torch.Generator().manual_seed(5)
    return torch.randn(b, cfg.n_patches, cfg.d_model,
                       generator=gen).to(device)


def _frames(cfg, b, device):
    if not cfg.is_encdec:
        return None
    gen = torch.Generator().manual_seed(7)
    return torch.randn(b, cfg.enc_frames, cfg.d_model,
                       generator=gen).to(device)


@pytest.mark.parametrize("name", FAMILIES)
def test_served_tokens_card_equals_cpu(cuda, name):
    cfg = _cfg(name)
    params = lm.init_params(cfg, seed=1, device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        srv = Server(cfg, ServeConfig(**SC), params, device=dev)
        assert srv.pooled == (name == "olmoe-1b-7b")
        reqs = _reqs(cfg.vocab)
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        out[str(dev)] = [r.out for r in reqs]
    assert out["cuda"] == out["cpu"]
    assert all(len(t) == SC["max_new_tokens"] for t in out["cpu"])


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_first_step_logits_card_equals_cpu(cuda, name):
    """Prefill (phi-3-vision's with random patches, whisper's with random
    frames) and one decode step, over the ring or, for olmoe, a coded
    pool holding the prefilled K/V."""
    cfg = _cfg(name)
    params = lm.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, SC["max_prompt"])))
    logits = {}
    for dev in ("cpu", cuda):
        p = lm.cast_params(cfg, params, dev)
        with torch.no_grad():
            lg, cache = lm.prefill(cfg, p, toks.to(dev), max_seq=32,
                                   patches=_patches(cfg, 2, dev),
                                   frames=_frames(cfg, 2, dev))
            tok = torch.argmax(lg, -1)
            if name == "olmoe-1b-7b":
                kvcfg = kb.KVBankConfig(n_banks=cfg.kv_banks, page=4,
                                        pool_pages=32, max_pages=8)
                pool = kb.pool_init(kvcfg, cfg.n_layers, 2, cfg.n_kv,
                                    cfg.head_dim, torch.float32, device=dev)
                for row in range(2):
                    pool.page_table[row] = torch.arange(8) * 2 + row
                    kb.pool_install(kvcfg, pool, row,
                                    cache["k"][:, row, :16],
                                    cache["v"][:, row, :16], fuse_encode=True)
                step, _, _ = lm.decode_step_pooled(cfg, kvcfg, p, tok, pool)
            else:
                step, _ = lm.decode_step(cfg, p, tok, cache)
        logits[str(dev)] = (lg.cpu(), step.cpu())
    for a, b in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def test_moe_block_routes_alike_card_and_cpu(cuda):
    """Reduced olmoe's MoE block on a decode group and a prefill group:
    the same router logits route alike on both devices (experts and keep
    mask), and the outputs agree within TOL of their largest magnitude."""
    cfg = _cfg("olmoe-1b-7b")
    p = moe.moe_init(cfg, torch.Generator().manual_seed(4), torch.float32)
    pc = {k: v.to(cuda) for k, v in p.items()}
    gen = torch.Generator().manual_seed(6)
    for shape in ((8, 1), (1, 64)):
        x = torch.randn(*shape, cfg.d_model, generator=gen)
        _, _, cap = moe.groups(cfg, shape[0] * shape[1])
        logits = moe.router_logits(cfg, p, x)
        r = moe.route(cfg, logits, cap)
        rc = moe.route(cfg, logits.to(cuda), cap)
        assert torch.equal(rc.idx.cpu(), r.idx)
        assert torch.equal(rc.keep.cpu(), r.keep)
        y = moe.experts(cfg, p, x, r, cap)
        yc = moe.experts(cfg, pc, x.to(cuda), rc, cap).cpu()
        assert float((yc - y).abs().max()) <= TOL * float(y.abs().max())


def test_serve_report_card_equals_cpu(cuda, tmp_path):
    """``serve_report`` at ``--smoke`` on the card passes both of its
    exact-equality gates; its planes and totals equal the CPU run's."""
    from repro_torch.obs import report

    out = {dev: report.serve_report(out_dir=str(tmp_path / dev), smoke=True,
                                    device=dev) for dev in ("cpu", "cuda")}
    assert out["cuda"]["snapshot"].as_dict() == \
        out["cpu"]["snapshot"].as_dict()
    assert [s["n_tokens"] for s in out["cuda"]["spans"]] == \
        [s["n_tokens"] for s in out["cpu"]["spans"]]
