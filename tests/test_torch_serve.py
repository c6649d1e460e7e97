"""The whole serving slice: the same request stream through the JAX
``Server`` (reference gather) and the port's ``Server(device="cpu")``, with
the JAX params carried across by ``convert.params_from_jax``, for each
dense config the port serves, reduced: qwen2.5-3b (tied coded embedding,
QKV bias), yi-6b (untied head), stablelm-12b (coded embedding, untied
head), granite-20b (LayerNorm, ungated GELU MLP, QKV bias), and two
variants that ``reduced()`` would hide: granite with its one kv head (MQA,
G = H) and stablelm with a 40-lane head (a row that is not a power of
two).

At f32 the served tokens are identical and the prefill and first decode
step logits agree to rtol=atol=1e-4 (the frameworks sum in different
orders). At bf16 the integer tables — page tables, lengths, code-status
table and each step's degraded-read plan — are identical: they do not
depend on the values."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro.runtime import kvbank as jkb
from repro.runtime import server as jserver
from repro_torch.configs.base import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.common import resolve_device
from repro_torch.models import lm as tlm
from repro_torch.runtime import kvbank as tkb
from repro_torch.runtime import server as tserver

TOL = dict(rtol=1e-4, atol=1e-4)
SC = dict(n_slots=3, max_prompt=8, max_seq=24, max_new_tokens=5)


# name: (config, fields replaced after reduced())
ARCHS = {
    "qwen2.5-3b": ("qwen2.5-3b", {}),
    "yi-6b": ("yi-6b", {}),
    "stablelm-12b": ("stablelm-12b", {}),
    "granite-20b": ("granite-20b", {}),
    "granite-20b-mqa": ("granite-20b", {"n_kv": 1}),
    "stablelm-12b-d40": ("stablelm-12b", {"head_dim": 40}),
}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch(request):
    return request.param


def _cfgs(arch, dtype):
    # page 4 divides max_seq, as in tests/test_serve.py
    name, extra = ARCHS[arch]
    return tuple(dataclasses.replace(g(name).reduced(), kv_page=4,
                                     compute_dtype=dtype, **extra)
                 for g in (jget_config, tget_config))


@pytest.fixture(scope="module")
def params(arch):
    jc, tc = _cfgs(arch, "bfloat16")
    jp = jlm.init_params(jc, jax.random.key(0), max_seq=48)
    return arch, jp, params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")


def test_params_from_jax_carries_every_leaf(params):
    """``convert.params_from_jax`` carries every leaf bit for bit: the
    untied ``lm_head`` (yi, stablelm) and LayerNorm's biases (granite)
    included."""
    arch, jp, tp = params
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(jax.tree_util.tree_leaves(tp))
    for path, a in jleaves:
        node = tp
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(a))
    cfg = _cfgs(arch, "float32")[1]
    assert ("lm_head" in tp) == (not cfg.tie_embeddings)
    assert ("bias" in tp["final_norm"]) == (cfg.norm == "layernorm")


def _reqs(server_mod, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [server_mod.Request(rid=i, prompt=[int(x) for x in rng.integers(
        1, 256, size=3 + i % 4)]) for i in range(n)]


def _drive(srv, reqs, on_step=None, permute_seed=None):
    for r in reqs:
        srv.submit(r)
    rng = np.random.default_rng(permute_seed)
    for step in range(200):
        srv._admit()
        if not any(s is not None for s in srv.slots):
            break
        if permute_seed is not None and step % 2 == 1:
            srv.permute_pool(rng.permutation(srv.kvcfg.pool_pages))
        if on_step is not None:
            on_step(step, srv)
        srv.step_decode()
    return [r.out for r in reqs]


def _np(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "i" else a


def _tables(pool):
    return {f: _np(getattr(pool, f)).copy()
            for f in ("page_table", "length", "parity_fresh")}


def _jax_plan(srv):
    pool = srv.cache["pool"]
    active = (pool.page_table[:, 0] >= 0) & (pool.length > 0)
    widx = jkb.pool_write_index(srv.kvcfg, pool, active)
    staled = jkb.pool_mark_stale(srv.kvcfg, pool, widx)
    return np.asarray(jkb.pool_plan(srv.kvcfg, staled,
                                    length=pool.length + active).use_parity)


def _port_plan(srv):
    pool = srv.cache["pool"]
    pool = dataclasses.replace(pool, parity_fresh=pool.parity_fresh.clone())
    active = (pool.page_table[:, 0] >= 0) & (pool.length > 0)
    widx = tkb.pool_write_index(srv.kvcfg, pool, active)
    tkb.pool_mark_stale(srv.kvcfg, pool, widx)
    return tkb.pool_plan(srv.kvcfg, pool,
                         length=pool.length + active).use_parity.numpy()


def _recorder(plan_fn, first_logits=None):
    rec = {"tables": [], "plans": [], "logits": None}

    def on_step(step, srv):
        rec["tables"].append(_tables(srv.cache["pool"]))
        rec["plans"].append(plan_fn(srv))
        if step == 0 and first_logits is not None:
            rec["logits"] = first_logits(srv)
    return rec, on_step


def _jax_first_logits(srv):
    logits, _, _ = jlm.decode_step_pooled(
        srv.cfg, srv.kvcfg, srv.params, srv.tokens, srv.cache["pool"], None)
    return np.asarray(logits)


def _port_first_logits(srv):
    pool = srv.cache["pool"]
    clone = tkb.PooledKV(**{f.name: getattr(pool, f.name).clone()
                            for f in dataclasses.fields(pool)})
    logits, _, _ = tlm.decode_step_pooled(srv.cfg, srv.kvcfg, srv.params,
                                          srv.tokens, clone)
    return logits.numpy()


@pytest.fixture(scope="module")
def runs(params):
    """Both packages over one churned request stream, at f32 and bf16."""
    arch, jp, tp = params
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, tc = _cfgs(arch, dtype)
        f32 = dtype == "float32"
        jrec, jhook = _recorder(_jax_plan, _jax_first_logits if f32 else None)
        trec, thook = _recorder(_port_plan,
                                _port_first_logits if f32 else None)
        jsrv = jserver.Server(jc, jserver.ServeConfig(**SC), jp)
        tsrv = tserver.Server(tc, tserver.ServeConfig(**SC), tp, device="cpu")
        # placement churn unbalances the banks, so plans go degraded
        jrec["tokens"] = _drive(jsrv, _reqs(jserver), jhook, permute_seed=5)
        trec["tokens"] = _drive(tsrv, _reqs(tserver), thook, permute_seed=5)
        out[dtype] = (jrec, trec)
    return out


def test_f32_served_tokens_identical(runs):
    jrec, trec = runs["float32"]
    assert trec["tokens"] == jrec["tokens"]
    assert all(len(t) == SC["max_new_tokens"] for t in trec["tokens"])


def test_f32_first_step_logits_agree(runs):
    jrec, trec = runs["float32"]
    np.testing.assert_allclose(trec["logits"], jrec["logits"], **TOL)


def test_f32_prefill_logits_and_kv_agree(params):
    arch, jp, tp = params
    jc, tc = _cfgs(arch, "float32")
    toks = np.random.default_rng(4).integers(0, 256, size=(2, 8))
    jl, jcache = jlm.prefill(jc, jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tcache = tlm.prefill(tc, tlm.cast_params(tc, tp, "cpu"),
                             torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for f in ("k", "v"):
        np.testing.assert_allclose(tcache[f].numpy(), np.asarray(jcache[f]),
                                   **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tables_and_plans_identical(runs, dtype):
    jrec, trec = runs[dtype]
    assert len(trec["tables"]) == len(jrec["tables"]) > 0
    for jt, tt in zip(jrec["tables"], trec["tables"]):
        for f in jt:
            np.testing.assert_array_equal(tt[f], jt[f])
    for jpl, tpl in zip(jrec["plans"], trec["plans"]):
        np.testing.assert_array_equal(tpl, jpl)
    assert any(p.any() for p in trec["plans"]), "no degraded read planned"


@pytest.fixture(scope="module")
def port_bf16_tokens(params, runs):
    arch, _, tp = params
    _, tc = _cfgs(arch, "bfloat16")

    def serve(permute_seed=None, **kw):
        srv = tserver.Server(tc, tserver.ServeConfig(**SC, **kw), tp,
                             device="cpu")
        return _drive(srv, _reqs(tserver), permute_seed=permute_seed)
    return runs["bfloat16"][1]["tokens"], serve


@pytest.mark.parametrize("variant", ["uncoded", "budget2", "never_recode",
                                     "churned"])
def test_port_pool_variants_serve_same_tokens(port_bf16_tokens, variant):
    coded_tokens, serve = port_bf16_tokens
    kw = {"uncoded": dict(coded=False), "budget2": dict(recode_budget=2),
          "never_recode": dict(recode_budget=-1), "churned": {}}[variant]
    seed = 3 if variant == "churned" else None
    assert serve(permute_seed=seed, **kw) == coded_tokens


def test_server_without_device_needs_a_card(params):
    """No silent CPU fallback: with no card, the default device raises."""
    arch, _, tp = params
    _, tc = _cfgs(arch, "bfloat16")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserver.Server(tc, tserver.ServeConfig(**SC), tp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_params(tc)


def test_unported_paths_raise(params):
    """The audio family serves now (the test keeps the name it had while
    it was refused): reduced whisper-tiny's ``Server`` takes the ring, its
    cross K/V sized to the admission's frames, and serves every request.
    What the port leaves out raises: a family with another family's
    positions (this decoder as "audio", with RoPE and no encoder); the
    pooled step refuses a sliding window (that config takes the ring)."""
    arch, _, tp = params
    _, tc = _cfgs(arch, "bfloat16")
    sc = tserver.ServeConfig(**SC)
    wc = tget_config("whisper-tiny").reduced()
    audio = tserver.Server(wc, sc, tlm.init_params(wc, seed=0, device="cpu"),
                           device="cpu")
    assert not audio.pooled and audio.cache["xk"].shape[2] == wc.enc_frames
    reqs = [tserver.Request(rid=i, prompt=[3 + i, 5]) for i in range(3)]
    for r in reqs:
        audio.submit(r)
    audio.run_until_drained()
    assert all(r.done and len(r.out) == SC["max_new_tokens"] for r in reqs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserver.Server(dataclasses.replace(tc, family="audio"), sc, tp,
                       device="cpu")
    srv = tserver.Server(tc, sc, tp, device="cpu")
    with pytest.raises(ValueError, match="sliding window"):
        tlm.decode_step_pooled(dataclasses.replace(tc, sliding_window=4),
                               srv.kvcfg, srv.params, srv.tokens,
                               srv.cache["pool"])
    ring = tserver.Server(dataclasses.replace(tc, kv_banks=0), sc, tp,
                          device="cpu")
    with pytest.raises(ValueError, match="pool"):
        ring.permute_pool(np.arange(4))


@pytest.mark.parametrize("variant", ["untied_head", "layernorm",
                                     "ungated_gelu"])
def test_dense_variants_serve(variant):
    """The dense variants the port once refused now serve from the port's
    own init: every request finishes, the coded and the uncoded pool
    serve the same tokens, and the init has the variant's leaves."""
    kw = {"untied_head": dict(tie_embeddings=False),
          "layernorm": dict(norm="layernorm"),
          "ungated_gelu": dict(mlp_gated=False, act="gelu")}[variant]
    _, tc = _cfgs("qwen2.5-3b", "float32")
    tc = dataclasses.replace(tc, **kw)
    tp = tlm.init_params(tc, seed=2, device="cpu")
    assert ("lm_head" in tp) == (variant == "untied_head")
    assert ("bias" in tp["blocks"]["norm1"]) == (variant == "layernorm")
    assert ("w_gate" in tp["blocks"]["mlp"]) == (variant != "ungated_gelu")
    out = []
    for coded in (True, False):
        srv = tserver.Server(tc, tserver.ServeConfig(**SC, coded=coded), tp,
                             device="cpu")
        out.append(_drive(srv, _reqs(tserver), permute_seed=5))
    assert out[0] == out[1]
    assert all(len(r) == SC["max_new_tokens"] for r in out[0])


def test_servelog_spans(params, tmp_path):
    arch, _, tp = params
    _, tc = _cfgs(arch, "bfloat16")
    srv = tserver.Server(tc, tserver.ServeConfig(**SC), tp, device="cpu")
    _drive(srv, _reqs(tserver, n=4))
    s = srv.log.summary()
    assert s["requests"] == s["finished"] == 4
    assert s["tokens"] == 4 * SC["max_new_tokens"]
    assert s["ttft_p50_s"] is not None and s["ttft_p50_s"] >= 0
    path = srv.log.export_chrome_trace(str(tmp_path / "t.json"), {"k": 1})
    blob = json.loads(open(path).read())
    names = {e["name"] for e in blob["traceEvents"]}
    assert "req 0" in names and "first token req 0" in names
    assert blob["otherData"]["manifest"] == {"k": 1}
