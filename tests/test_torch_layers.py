"""The port's model layers and embeddings against the JAX package's, on the
same numpy inputs. Float layers at f32 with rtol=atol=1e-5 (the two
frameworks sum in different orders); coded and plain lookups bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import embedding as jemb
from repro.models import layers as jly
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import embedding as temb
from repro_torch.models import layers as tly

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def cfgs():
    return (jget_config("qwen2.5-3b").reduced(),
            tget_config("qwen2.5-3b").reduced())


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


DENSE = ("qwen2.5-3b", "yi-6b", "stablelm-12b", "granite-20b")


def test_port_config_matches_jax():
    """Every dense config the port serves, full and reduced, field for
    field."""
    for name in DENSE:
        full_j, full_t = jget_config(name), tget_config(name)
        for a, b in ((full_j, full_t), (full_j.reduced(), full_t.reduced())):
            for f in dataclasses.fields(b):
                assert getattr(a, f.name) == getattr(b, f.name), \
                    (name, f.name)
            assert a.vocab_pad == b.vocab_pad


def test_apply_norm(cfgs):
    jc, tc = cfgs
    rng = np.random.default_rng(0)
    x, s = _f32(rng, 2, 5, jc.d_model), _f32(rng, jc.d_model)
    _close(tly.apply_norm(tc, {"scale": torch.from_numpy(s)},
                          torch.from_numpy(x)),
           jly.apply_norm(jc, {"scale": jnp.asarray(s)}, jnp.asarray(x)))


def test_apply_layernorm(cfgs):
    """LayerNorm with its bias, eps 1e-5 and the population variance, on
    rows with a large mean (where an unbiased variance would show)."""
    jc, tc = (dataclasses.replace(c, norm="layernorm") for c in cfgs)
    rng = np.random.default_rng(10)
    x = _f32(rng, 2, 5, jc.d_model) + 3.0
    p = {"scale": _f32(rng, jc.d_model), "bias": _f32(rng, jc.d_model)}
    _close(tly.apply_norm(tc, {k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x)),
           jly.apply_norm(jc, {k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x)))
    init = tly.norm_init(tc, torch.float32, "cpu", (3,))
    jinit = jly.norm_init(jc, jnp.float32)
    assert init.keys() == jinit.keys()
    assert tuple(init["bias"].shape) == (3, jc.d_model)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = _f32(rng, 2, 6, 4, 32)
    pos = rng.integers(0, 300, size=(2, 6))
    _close(tly.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jly.rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_qkv_proj(cfgs):
    jc, tc = cfgs
    rng = np.random.default_rng(2)
    d, hd = jc.d_model, jc.head_dim
    p = {"wq": _f32(rng, d, jc.n_heads * hd, scale=d ** -0.5),
         "wk": _f32(rng, d, jc.n_kv * hd, scale=d ** -0.5),
         "wv": _f32(rng, d, jc.n_kv * hd, scale=d ** -0.5),
         "bq": _f32(rng, jc.n_heads * hd), "bk": _f32(rng, jc.n_kv * hd),
         "bv": _f32(rng, jc.n_kv * hd)}
    x = _f32(rng, 2, 3, d)
    tq = tly.qkv_proj(tc, {k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x))
    jq = jly.qkv_proj(jc, {k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x))
    for t, j in zip(tq, jq):
        _close(t, j)


@pytest.mark.parametrize("kind", ["causal", "decode_lengths"])
def test_mha(kind):
    rng = np.random.default_rng(3)
    b, h, hkv, dh = 2, 4, 2, 32
    if kind == "causal":
        tq = tk = 7
        q = _f32(rng, b, tq, h, dh)
        jm = jly.causal_mask(tq, tk)
        tm = tly.causal_mask(tq, tk, "cpu")
    else:
        tq, tk = 1, 12
        q = _f32(rng, b, tq, h, dh)
        lens = np.array([5, 12])
        m = (np.arange(tk)[None, :] < lens[:, None])[:, None, None, None, :]
        jm, tm = jnp.asarray(m), torch.from_numpy(m)
    k, v = _f32(rng, b, tk, hkv, dh), _f32(rng, b, tk, hkv, dh)
    _close(tly.mha(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), tm),
           jly.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm))


def test_mlp_block(cfgs):
    jc, tc = cfgs
    rng = np.random.default_rng(4)
    d, f = jc.d_model, jc.d_ff
    p = {"w_up": _f32(rng, d, f, scale=d ** -0.5),
         "w_gate": _f32(rng, d, f, scale=d ** -0.5),
         "w_down": _f32(rng, f, d, scale=f ** -0.5)}
    x = _f32(rng, 2, 3, d)
    _close(tly.mlp_block(tc, {k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x)),
           jly.mlp_block(jc, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x)))


def test_mlp_block_ungated_gelu(cfgs):
    """granite's MLP: gelu(x @ W_up) @ W_down with the tanh GELU of
    ``jax.nn.gelu``; the init has no gate."""
    jc, tc = (dataclasses.replace(c, mlp_gated=False, act="gelu")
              for c in cfgs)
    rng = np.random.default_rng(8)
    d, f = jc.d_model, jc.d_ff
    p = {"w_up": _f32(rng, d, f, scale=d ** -0.5),
         "w_down": _f32(rng, f, d, scale=f ** -0.5)}
    x = _f32(rng, 2, 3, d) * 3.0
    _close(tly.mlp_block(tc, {k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x)),
           jly.mlp_block(jc, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x)))
    gen = torch.Generator().manual_seed(0)
    tp = tly.mlp_init(tc, gen, torch.float32, (2,))
    assert tp.keys() == jly.mlp_init(jc, jax.random.key(0),
                                     jnp.float32).keys()
    assert tuple(tp["w_up"].shape) == (2, d, f)


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` approximates by default; the erf form is ~1e-3 off
    and would fail the 1e-4 logits check."""
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    cfg = tget_config("granite-20b").reduced()
    got = tly._act(cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               **TOL)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - got).max() > 1e-4


@pytest.mark.parametrize("name", ["yi-6b", "stablelm-12b"])
def test_untied_logits(name):
    """An untied head: ``x @ lm_head`` in f32 with the padding ids masked,
    against the JAX ``_logits``; the tied path is not taken (stablelm's
    coded banks are ignored)."""
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm
    jc = dataclasses.replace(jget_config(name).reduced(), vocab=500)
    tc = dataclasses.replace(tget_config(name).reduced(), vocab=500)
    rng = np.random.default_rng(9)
    head = _f32(rng, jc.d_model, jc.vocab_pad, scale=jc.d_model ** -0.5)
    x = _f32(rng, 2, 3, jc.d_model)
    p = {"lm_head": head, "embed": {"banks": _banks(jc, rng)}
         if jc.coded_embedding else {"table": _f32(rng, jc.vocab_pad,
                                                   jc.d_model)}}
    got = tlm._logits(tc, {"lm_head": torch.from_numpy(head),
                           "embed": {k: torch.from_numpy(v)
                                     for k, v in p["embed"].items()}},
                      torch.from_numpy(x))
    want = jlm._logits(jc, {"lm_head": jnp.asarray(head),
                            "embed": {k: jnp.asarray(v)
                                      for k, v in p["embed"].items()}},
                       jnp.asarray(x))
    _close(got, want)
    assert (got[..., jc.vocab:] == -1e30).all()


def _banks(cfg, rng):
    nb = cfg.embed_banks
    return _f32(rng, nb, -(-cfg.vocab_pad // nb), cfg.d_model, scale=0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coded_lookup_bit_exact(cfgs, dtype):
    jc, tc = cfgs
    rng = np.random.default_rng(5)
    banks = _banks(jc, rng)
    # repeats on one bank exercise the degraded (odd-rank) reads
    tokens = rng.integers(0, jc.vocab, size=(3, 9))
    tokens[0, :4] = [8, 16, 24, 32]
    jb = jnp.asarray(banks).astype(dtype)
    tb = torch.from_numpy(banks).to(getattr(torch, dtype))
    jo = jemb.embed_lookup(jc, {"banks": jb}, jnp.asarray(tokens), jb.dtype)
    to = temb.embed_lookup(tc, {"banks": tb}, torch.from_numpy(tokens),
                           tb.dtype)
    with_par = temb.embed_lookup(
        tc, {"banks": tb, "par": temb.coded_parity(tb)},
        torch.from_numpy(tokens), tb.dtype)
    u = np.uint16 if dtype == "bfloat16" else np.uint32
    s = torch.int16 if dtype == "bfloat16" else torch.int32
    ref = np.asarray(jo).view(u)
    np.testing.assert_array_equal(to.view(s).numpy().view(u), ref)
    np.testing.assert_array_equal(with_par.view(s).numpy().view(u), ref)
    plan = temb._plan_use_parity(torch.from_numpy(tokens % 8), 8)
    np.testing.assert_array_equal(
        plan.numpy(), np.asarray(jemb._plan_use_parity(
            jnp.asarray(tokens % 8, jnp.int32), 8)))
    assert plan.any()


def test_plain_lookup_and_tables(cfgs):
    jc, tc = cfgs
    jp_c = dataclasses.replace(jc, coded_embedding=False)
    tp_c = dataclasses.replace(tc, coded_embedding=False)
    rng = np.random.default_rng(6)
    table = _f32(rng, jc.vocab_pad, jc.d_model)
    tokens = rng.integers(0, jc.vocab, size=(2, 5))
    np.testing.assert_array_equal(
        temb.embed_lookup(tp_c, {"table": torch.from_numpy(table)},
                          torch.from_numpy(tokens), torch.float32).numpy(),
        np.asarray(jemb.embed_lookup(jp_c, {"table": jnp.asarray(table)},
                                     jnp.asarray(tokens), jnp.float32)))
    banks = _banks(jc, rng)
    np.testing.assert_array_equal(
        temb.full_table(tc, {"banks": torch.from_numpy(banks)}).numpy(),
        np.asarray(jemb.full_table(jc, {"banks": jnp.asarray(banks)})))


@pytest.mark.parametrize("coded", [True, False])
def test_tied_logits_match_full_table_product(cfgs, coded):
    jc, tc = (dataclasses.replace(c, coded_embedding=coded) for c in cfgs)
    rng = np.random.default_rng(7)
    p = {"banks": _banks(jc, rng)} if coded \
        else {"table": _f32(rng, jc.vocab_pad, jc.d_model, scale=0.1)}
    x = _f32(rng, 2, 3, jc.d_model)
    head = jemb.full_table(jc, {k: jnp.asarray(v) for k, v in p.items()}).T
    _close(temb.tied_logits(tc, {k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x)),
           jnp.asarray(x) @ head, rtol=1e-5, atol=1e-5)


def test_embed_init_shapes(cfgs):
    jc, tc = cfgs
    jp = jemb.embed_init(jc, jax.random.key(0), jnp.float32)
    gen = torch.Generator().manual_seed(0)
    tp = temb.embed_init(tc, gen, torch.float32)
    assert tp.keys() == jp.keys()
    assert tuple(tp["banks"].shape) == jp["banks"].shape
