"""The ring cache of the port (``layers.attention_decode``, ``lm.cache_spec``,
``lm.decode_step``, the ring placement of ``lm.prefill``, the ring branch
of ``Server``) against the JAX package, global and with a sliding window
of 16. Params are carried across by ``convert.params_from_jax``.

Tolerances at f32: 1e-5 for one attention call, 1e-4 for logits after the
whole model (the frameworks sum in different orders). Cache placement and
served tokens are compared exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import layers as jly
from repro.models import lm as jlm
from repro.runtime import server as jserver
from repro_torch.configs.base import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as tly
from repro_torch.models import lm as tlm
from repro_torch.runtime import server as tserver

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
WINDOW = 16
SC = dict(n_slots=3, max_prompt=16, max_seq=32, max_new_tokens=6)


def _cfgs(dtype="float32", window=0, kv_banks=None):
    out = []
    for g in (jget_config, tget_config):
        c = dataclasses.replace(g("qwen2.5-3b").reduced(), kv_page=4,
                                compute_dtype=dtype, sliding_window=window)
        if kv_banks is not None:
            c = dataclasses.replace(c, kv_banks=kv_banks)
        out.append(c)
    return tuple(out)


@pytest.fixture(scope="module")
def params():
    jc, tc = _cfgs()
    jp = jlm.init_params(jc, jax.random.key(0), max_seq=64)
    return jp, params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("tq,tk,offset,window", [
    (5, 5, 0, 0), (4, 9, 5, 0), (8, 8, 0, 3), (3, 12, 9, 4), (1, 7, 6, 16)])
def test_causal_mask_matches_jax(tq, tk, offset, window):
    want = np.asarray(jly.causal_mask(tq, tk, offset, window))
    got = tly.causal_mask(tq, tk, "cpu", offset, window).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window,cap", [(0, 24), (WINDOW, WINDOW)])
def test_attention_decode_matches_jax(params, window, cap):
    """One token over a ring cache at mixed positions (before, at and past
    the ring's wrap): output within 1e-5, caches written identically."""
    jp, tp = params
    jc, tc = _cfgs(window=window)
    rng = np.random.default_rng(window)
    b = 4
    x = rng.normal(size=(b, 1, jc.d_model)).astype(np.float32)
    kc = rng.normal(size=(b, cap, jc.n_kv, jc.head_dim)).astype(np.float32)
    vc = rng.normal(size=(b, cap, jc.n_kv, jc.head_dim)).astype(np.float32)
    pos = np.asarray([0, 5, cap - 1, cap + 7], np.int32)
    jattn = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tattn = tlm.layer_params(tp["blocks"], 0)["attn"]
    jo, jk, jv = jly.attention_decode(jc, jattn, jnp.asarray(x),
                                      jnp.asarray(pos), jnp.asarray(kc),
                                      jnp.asarray(vc), window)
    tk, tv = _t(kc), _t(vc)
    to, tk2, tv2 = tly.attention_decode(tc, tattn, _t(x), _t(pos), tk, tv,
                                        window)
    assert tk2 is tk and tv2 is tv, "the caches are written in place"
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **ATTN_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **ATTN_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **ATTN_TOL)
    # the untouched slots are bit-identical
    slot = pos % cap
    keep = np.ones((b, cap), bool)
    keep[np.arange(b), slot] = False
    np.testing.assert_array_equal(tk.numpy()[keep], kc[keep])


@pytest.mark.parametrize("window", [0, WINDOW])
def test_cache_spec_matches_jax(window):
    jc, tc = _cfgs(window=window)
    want = jlm.cache_spec(jc, 3, 40)
    got = tlm.cache_spec(tc, 3, 40, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert not got[k].any()
    assert got["pos"].dtype == torch.int32
    assert got["k"].dtype == getattr(torch, tc.compute_dtype)


# ------------------------------------------------------- prefill + decode
@pytest.mark.parametrize("window,s,max_seq", [
    (0, 12, None), (0, 12, 32), (WINDOW, 12, 40), (WINDOW, 24, 40)],
    ids=["global_no_headroom", "global", "window_short_prompt",
         "window_long_prompt"])
def test_ring_prefill_matches_jax(params, window, s, max_seq):
    """Prefill logits within 1e-4; the ring placement (token j in slot
    j % C, the last C tokens) the same as JAX's."""
    jp, tp = params
    jc, tc = _cfgs(window=window)
    toks = np.random.default_rng(s).integers(1, 256, size=(2, s))
    jl, jcache = jlm.prefill(jc, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             max_seq=max_seq)
    tl, tcache = tlm.prefill(tc, tlm.cast_params(tc, tp, "cpu"),
                             torch.from_numpy(toks), max_seq=max_seq)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for f in ("k", "v"):
        assert tuple(tcache[f].shape) == jcache[f].shape
        np.testing.assert_allclose(tcache[f].numpy(), np.asarray(jcache[f]),
                                   **LOGIT_TOL)
        # empty ring slots are exact zeros on both sides
        np.testing.assert_array_equal(tcache[f].numpy() == 0,
                                      np.asarray(jcache[f]) == 0)


@pytest.mark.parametrize("window", [0, WINDOW], ids=["global", "window16"])
def test_decode_step_matches_jax(params, window):
    """Prefill with headroom, then decode steps past the window's wrap:
    every step's logits within 1e-4 and the same greedy tokens."""
    jp, tp = params
    jc, tc = _cfgs(window=window)
    tpc = tlm.cast_params(tc, tp, "cpu")
    toks = np.random.default_rng(7).integers(1, 256, size=(2, 12))
    _, jcache = jlm.prefill(jc, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                            max_seq=32)
    _, tcache = tlm.prefill(tc, tpc, torch.from_numpy(toks), max_seq=32)
    tok = np.asarray([3, 77], np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok).long()
    for _ in range(10):                 # positions 12 .. 21 (> 16)
        jl, jcache = jlm.decode_step(jc, jp, jtok, jcache)
        tl, tcache = tlm.decode_step(tc, tpc, ttok, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for f in ("k", "v"):
        np.testing.assert_allclose(tcache[f].numpy(), np.asarray(jcache[f]),
                                   **LOGIT_TOL)


# ------------------------------------------------------------ the server
def _reqs(mod, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=[int(x) for x in rng.integers(
        1, 256, size=3 + i % 4)]) for i in range(n)]


def _serve(srv, reqs):
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return [r.out for r in reqs]


@pytest.mark.parametrize("window", [0, WINDOW], ids=["global", "window16"])
def test_ring_server_serves_jax_tokens(params, window):
    """The ring branch of the server (kv_banks=0, or a sliding window)
    serves the JAX ring server's tokens at f32."""
    jp, tp = params
    jc, tc = _cfgs(window=window, kv_banks=0 if window == 0 else None)
    jsrv = jserver.Server(jc, jserver.ServeConfig(**SC), jp)
    tsrv = tserver.Server(tc, tserver.ServeConfig(**SC), tp, device="cpu")
    assert not jsrv.pooled and not tsrv.pooled
    assert _serve(tsrv, _reqs(tserver)) == _serve(jsrv, _reqs(jserver))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_tokens_equal_pool_tokens(params, dtype):
    """As tests/test_serve.py:72: with MP * page == max_seq the pooled
    decode reads the same logical K/V in the same order as the ring, so
    turning the banks off (kv_banks=0) changes no token."""
    _, tp = params
    _, tc = _cfgs(dtype)
    sc = tserver.ServeConfig(**SC)
    pool = tserver.Server(tc, sc, tp, device="cpu")
    ring = tserver.Server(dataclasses.replace(tc, kv_banks=0), sc, tp,
                          device="cpu")
    assert pool.pooled and not ring.pooled
    assert pool.kvcfg.max_pages * pool.kvcfg.page == SC["max_seq"]
    assert _serve(ring, _reqs(tserver)) == _serve(pool, _reqs(tserver))


def test_ring_server_refuses_a_window_past_the_prompt(params):
    _, tp = params
    _, tc = _cfgs(window=WINDOW)
    with pytest.raises(ValueError, match="window"):
        tserver.Server(tc, tserver.ServeConfig(**dict(SC, max_prompt=8)),
                       tp, device="cpu")
