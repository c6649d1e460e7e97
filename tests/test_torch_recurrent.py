"""The recurrent families of the port against the JAX package on the CPU:
``models/ssm.py`` (mamba2's SSD mixer and its O(1) decode state),
``models/rglru.py`` (recurrentgemma's RG-LRU block and its state), the
ssm and hybrid branches of ``models/lm.py`` and the ring ``Server`` that
serves them, reduced, at ``compute_dtype="float32"``. JAX params are
carried across by ``convert.params_from_jax``, with the SSM's ``A_log``,
``D``, ``dt_bias`` and the RG-LRU's ``lam`` redrawn from a seed (JAX's
init makes them constants, which would hide their dtypes and decays).

Tolerances at f32: the mixers and their decode steps within atol = rtol
= 1e-5 (the frameworks sum in different orders; the RG-LRU scan
associates in another order than ``lax.associative_scan``); logits
within 1e-4; greedy and served tokens identical.

The hybrid ``Server`` is held against JAX's at ``n_layers=8`` (two
attention layers): JAX's ``Server`` drops the ring install of every slot
but 0 when the attention stack has one layer (its shape guess in
``_install_ring``), so at the default reduced depth (one attention
layer) the port is held against its own per-request prefill and decode
instead."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro.models import rglru as jrg
from repro.models import ssm as jssm
from repro.runtime import server as jserver
from repro_torch.configs.base import get_config as tget_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.models import lm as tlm
from repro_torch.models import rglru as trg
from repro_torch.models import ssm as tssm
from repro_torch.optim.adamw import OptConfig, adamw_init, tree_leaves
from repro_torch.runtime import server as tserver
from repro_torch.runtime import steps as tsteps

MIX_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("mamba2-2.7b", "recurrentgemma-9b")
SC = dict(n_slots=3, max_prompt=16, max_seq=32, max_new_tokens=6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: one intra-op thread each keeps six test
    workers from oversubscribing the cores (torch starts one a core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **extra):
    return tuple(dataclasses.replace(g(name).reduced(),
                                     compute_dtype="float32", **extra)
                 for g in (jget_config, tget_config))


def _t(a):
    return torch.from_numpy(np.array(a))


def _redraw_scalars(tree, seed=0):
    """``A_log``, ``D``, ``dt_bias`` and ``lam`` redrawn (f32, as JAX
    keeps them) so the decays and skips differ per head and channel."""
    rng = np.random.default_rng(seed)
    draw = {"A_log": lambda s: rng.uniform(-1.0, 1.5, s),
            "D": lambda s: rng.normal(1.0, 0.5, s),
            "dt_bias": lambda s: rng.normal(0.0, 1.0, s),
            "lam": lambda s: rng.normal(0.5, 1.0, s)}

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    draw[k](v.shape).astype(np.float32) if k in draw
                    else np.asarray(v)) for k, v in node.items()}
    return walk(tree)


def _model(name, **extra):
    return _model_of(name, tuple(sorted(extra.items())))


@functools.lru_cache(maxsize=None)
def _jit(fn, *static, **kw):
    """``fn`` jitted with its leading (config) arguments bound, one
    compile per argument shape: JAX's eager dispatch costs more."""
    return jax.jit(functools.partial(fn, *static, **kw))


@functools.lru_cache(maxsize=None)
def _model_of(name, extra):
    """The configs and one param tree in both packages (shared by the
    tests: neither package writes into its params)."""
    jc, tc = _cfgs(name, **dict(extra))
    init = jax.jit(lambda k: jlm.init_params(jc, k))
    host = _redraw_scalars(jax.tree.map(np.asarray,
                                        init(jax.random.key(0))))
    jp = jax.tree.map(jnp.asarray, host)
    tp = params_from_jax(tc, host, "cpu")
    return jc, tc, host, jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


# ---------------------------------------------------------------- configs
def test_configs_copy_jax():
    """Every field of the two configs has JAX's value, full and reduced,
    and the analytic parameter counts agree."""
    for name in ARCHS:
        for j, t in ((jget_config(name), tget_config(name)),
                     (jget_config(name).reduced(),
                      tget_config(name).reduced())):
            for f in dataclasses.fields(t):
                assert getattr(t, f.name) == getattr(j, f.name), (name,
                                                                  f.name)
            assert t.n_params() == j.n_params()
    assert tget_config("recurrentgemma-9b").reduced().n_layers == 3
    assert tlm.hybrid_layout(tget_config("recurrentgemma-9b")) == (12, 2, 12)


def test_params_round_trip_keeps_dtypes(model):
    """``params_from_jax`` and back: every leaf bit for bit in its own
    dtype (the f32 ``A_log``/``D``/``dt_bias``/``lam`` stay f32)."""
    jc, tc, host, _, tp = model
    back = params_to_numpy(tp)
    flat = jax.tree_util.tree_leaves_with_path(host)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, a in flat:
        node = back
        for key in path:
            node = node[key.key]
        assert node.dtype == a.dtype
        np.testing.assert_array_equal(node, a)
    leaf = tp["blocks"]["ssm"]["A_log"] if jc.family == "ssm" \
        else tp["rec_blocks"]["rglru"]["lam"]
    assert leaf.dtype == torch.float32


def test_port_init_has_jax_shapes(model):
    """The port's own init draws JAX's leaves with JAX's shapes."""
    _, tc, host, _, _ = model
    tp = tlm.init_params(tc, seed=1, device="cpu", dtype=torch.float32)
    want = {jax.tree_util.keystr(p): a.shape
            for p, a in jax.tree_util.tree_leaves_with_path(host)}
    got = {jax.tree_util.keystr(p): tuple(a.shape)
           for p, a in jax.tree_util.tree_leaves_with_path(tp)}
    assert got == want


# ------------------------------------------------------------------- ssm
def _ssm_layer(host, tp):
    return (jax.tree.map(lambda a: jnp.asarray(a[0]),
                         host["blocks"]["ssm"]),
            tlm.layer_params(tp["blocks"]["ssm"], 0))


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tssm._causal_conv(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX_TOL)


def test_ssd_chunked_matches_jax():
    """Four chunks of 8 over T = 32, decays steep enough that
    exp(cum_i - cum_j) overflows above the diagonal: finite, equal."""
    rng = np.random.default_rng(2)
    b, t, h, p, n = 2, 32, 3, 4, 5
    u = rng.normal(size=(b, t, h, p)).astype(np.float32)
    la = -rng.exponential(6.0, size=(b, t, h)).astype(np.float32)
    bm = rng.normal(size=(b, t, n)).astype(np.float32)
    cm = rng.normal(size=(b, t, n)).astype(np.float32)
    with np.errstate(over="ignore"):
        assert np.exp(-la.reshape(b, 4, 8, h).sum(2)).max() == np.inf
    jy, js = _jit(jssm._ssd_chunked, chunk=8)(*map(jnp.asarray,
                                                    (u, la, bm, cm)))
    ty, ts = tssm._ssd_chunked(*map(_t, (u, la, bm, cm)), 8)
    assert bool(torch.isfinite(ty).all())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MIX_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **MIX_TOL)
    with pytest.raises(ValueError, match="chunk"):
        tssm._ssd_chunked(*map(_t, (u[:, :12], la[:, :12], bm[:, :12],
                                    cm[:, :12])), 8)


def test_ssm_block_and_decode_match_jax():
    """The block at chunk 8 over T = 32 with its cache, then three decode
    steps: outputs, conv tail and f32 state within 1e-5, the port's
    cache updated in place."""
    jc, tc, host, _, tp = _model("mamba2-2.7b")
    jlp, tlp = _ssm_layer(host, tp)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 32, jc.d_model)).astype(np.float32)
    jo, jcache = _jit(jssm.ssm_block, jc, chunk=8, return_cache=True)(
        jlp, jnp.asarray(x))
    to, tcache = tssm.ssm_block(tc, tlp, _t(x), chunk=8, return_cache=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MIX_TOL)
    for f in ("conv", "state"):
        np.testing.assert_allclose(getattr(tcache, f).numpy(),
                                   np.asarray(getattr(jcache, f)), **MIX_TOL)
    state = tcache.state
    for _ in range(3):
        xt = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
        jo, jcache = _jit(jssm.ssm_decode, jc)(jlp, jnp.asarray(xt), jcache)
        to, tcache = tssm.ssm_decode(tc, tlp, _t(xt), tcache)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MIX_TOL)
        for f in ("conv", "state"):
            np.testing.assert_allclose(getattr(tcache, f).numpy(),
                                       np.asarray(getattr(jcache, f)),
                                       **MIX_TOL)
    assert tcache.state is state


# ----------------------------------------------------------------- rglru
@pytest.mark.parametrize("t", [1, 13])
def test_rglru_block_and_decode_match_jax(t):
    """The block over T (13: not a power of two; 1: shorter than the conv
    tail) with its cache, then three decode steps (1e-5)."""
    jc, tc, host, _, tp = _model("recurrentgemma-9b")
    jlp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       host["rec_blocks"]["rglru"])
    tlp = tlm.layer_params(tp["rec_blocks"]["rglru"], 0)
    rng = np.random.default_rng(t)
    x = rng.normal(size=(2, t, jc.d_model)).astype(np.float32)
    jo, jcache = _jit(jrg.rglru_block, jc, return_cache=True)(
        jlp, jnp.asarray(x))
    to, tcache = trg.rglru_block(tc, tlp, _t(x), return_cache=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MIX_TOL)
    for f in ("conv", "h"):
        np.testing.assert_allclose(getattr(tcache, f).numpy(),
                                   np.asarray(getattr(jcache, f)), **MIX_TOL)
    for _ in range(3):
        xt = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
        jo, jcache = _jit(jrg.rglru_decode, jc)(jlp, jnp.asarray(xt), jcache)
        to, tcache = trg.rglru_decode(tc, tlp, _t(xt), tcache)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MIX_TOL)
        np.testing.assert_allclose(tcache.h.numpy(), np.asarray(jcache.h),
                                   **MIX_TOL)


def test_rg_scan_bf16_matches_jax():
    """``rg_scan_bf16`` runs the scan on bf16 (a, w) in both packages:
    within bf16's rounding of each other, and apart from the f32 scan."""
    jc, tc, host, _, tp = _model("recurrentgemma-9b")
    jc, tc = (dataclasses.replace(c, rg_scan_bf16=True) for c in (jc, tc))
    jlp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       host["rec_blocks"]["rglru"])
    tlp = tlm.layer_params(tp["rec_blocks"]["rglru"], 0)
    x = np.random.default_rng(5).normal(size=(1, 13, jc.d_model)) \
        .astype(np.float32)
    jo = _jit(jrg.rglru_block, jc)(jlp, jnp.asarray(x))
    to = trg.rglru_block(tc, tlp, _t(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-2,
                               atol=2e-2)
    f32 = trg.rglru_block(dataclasses.replace(tc, rg_scan_bf16=False), tlp,
                          _t(x))
    assert not torch.equal(f32, to)


# ------------------------------------------------- prefill and decode
def test_prefill_and_decode_match_jax(model):
    """Prefill over 16 positions (the hybrid's local window of 16 wraps
    from the first decode step on), then five decode steps: logits within
    1e-4, the same greedy tokens, the recurrent states within 1e-4."""
    jc, tc, _, jp, tp = model
    tpc = tlm.cast_params(tc, tp, "cpu")
    toks = np.random.default_rng(4).integers(0, 256, size=(2, 16))
    jl, jcache = _jit(jlm.prefill, jc, max_seq=24)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tcache = tlm.prefill(tc, tpc, _t(toks), max_seq=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jstep = _jit(jlm.decode_step, jc)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = torch.argmax(tl, -1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for _ in range(5):
        jl, jcache = jstep(jp, jtok, jcache)
        tl, tcache = tlm.decode_step(tc, tpc, ttok, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    key = "ssm" if jc.family == "ssm" else "rg"
    for a, b in zip(tcache[key], jcache[key]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert int(tcache["pos"][0]) == 21


# ------------------------------------------------------------ the server
def _reqs(mod, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=[int(x) for x in rng.integers(
        1, 256, size=3 + 4 * i)]) for i in range(n)]


def _drive(srv, reqs):
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return [r.out for r in reqs]


@pytest.mark.parametrize("name,extra", [("mamba2-2.7b", {}),
                                        ("recurrentgemma-9b",
                                         {"n_layers": 8})])
def test_server_matches_jax(name, extra):
    """The JAX ``Server`` and the port's on the ring over 5 requests of
    3..19 tokens on 3 slots (prompts cut to 16, staggered admissions):
    tokens identical, every request finished."""
    jc, tc, _, jp, tp = _model(name, **extra)
    if jc.family == "hybrid":
        assert tlm.hybrid_layout(tc) == (2, 2, 2)
    jsrv = jserver.Server(jc, jserver.ServeConfig(**SC), jp)
    tsrv = tserver.Server(tc, tserver.ServeConfig(**SC), tp, device="cpu")
    assert not jsrv.pooled and not tsrv.pooled
    want = _drive(jsrv, _reqs(jserver))
    got = _drive(tsrv, _reqs(tserver))
    assert got == want
    assert all(len(t) == SC["max_new_tokens"] for t in got)


def _alone(cfg, params, prompt, sc):
    """One request by ``prefill`` and ``decode_step``, the server's way:
    left-padded to ``max_prompt``."""
    p = prompt[-sc.max_prompt:]
    toks = torch.tensor([[0] * (sc.max_prompt - len(p)) + p])
    logits, cache = tlm.prefill(cfg, params, toks, max_seq=sc.max_seq)
    out = [int(logits.argmax(-1)[0])]
    while len(out) < sc.max_new_tokens:
        logits, cache = tlm.decode_step(cfg, params, torch.tensor(out[-1:]),
                                        cache)
        out.append(int(logits.argmax(-1)[0]))
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_server_equals_each_request_alone(name):
    """At the default reduced depth (the hybrid: one attention layer, the
    case JAX's ``Server`` drops) each slot's ring, conv tails and states
    are installed in place: the served tokens equal each request's own
    prefill + decode; a snapshot restored into a fresh server mid-stream
    finishes with the same tokens."""
    _, tc, _, _, tp = _model(name)
    sc = tserver.ServeConfig(**SC)
    srv = tserver.Server(tc, sc, tp, device="cpu")
    reqs = _reqs(tserver)
    for r in reqs:
        srv.submit(r)
    for _ in range(3):
        srv.step()
    snap = srv.snapshot()
    queue = [(r.rid, list(r.prompt), list(r.out)) for r in srv.queue]
    srv.run_until_drained()
    for r in reqs:
        assert r.out == _alone(tc, srv.params, r.prompt, sc), r.rid
    node = tserver.Server(tc, sc, tp, device="cpu")
    node.restore_snapshot(snap)
    node.queue = [tserver.Request(rid=q[0], prompt=q[1], out=q[2])
                  for q in queue]
    moved = [r for r in node.slots if r] + node.queue
    node.run_until_drained()
    by_rid = {r.rid: r.out for r in reqs}
    assert moved and all(r.out == by_rid[r.rid] for r in moved)


def test_server_refuses_a_local_window_past_max_prompt():
    _, tc, _, _, tp = _model("recurrentgemma-9b")
    with pytest.raises(ValueError, match="window 16 exceeds max_prompt 8"):
        tserver.Server(tc, tserver.ServeConfig(n_slots=2, max_prompt=8,
                                               max_seq=32), tp,
                       device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_launch_serve_reduced_on_the_cpu(name, capsys):
    """``python -m repro_torch.launch.serve --arch <name> --reduced
    --device cpu`` serves every request from the ring."""
    tlaunch_serve.main(["--arch", name, "--reduced", "--device", "cpu",
                        "--requests", "3", "--slots", "2", "--max-new", "3",
                        "--max-prompt", "16", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out and "ring cache" in out


def test_launch_serve_asks_for_the_local_window(capsys):
    with pytest.raises(SystemExit):
        tlaunch_serve.main(["--arch", "recurrentgemma-9b", "--reduced",
                            "--device", "cpu", "--max-prompt", "8"])
    assert "--max-prompt >= 16" in capsys.readouterr().err


@pytest.mark.parametrize("name", ARCHS)
def test_training_refuses_ssm_and_hybrid(name):
    """The two families train now (the test keeps the name it had while
    they were refused): two steps of ``make_train_step`` from the port's
    init, every loss and param finite and the step count advanced
    (``tests/test_torch_train_families.py`` holds a step against JAX)."""
    _, tc = _cfgs(name)
    tp = tlm.init_params(tc, seed=0, device="cpu", dtype=torch.float32)
    st = adamw_init(tp)
    step = tsteps.make_train_step(tc, OptConfig())
    toks = torch.randint(0, tc.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        tp, st, m = step(tp, st, {"tokens": toks})
        assert np.isfinite(float(m["loss"]))
    assert int(st.step) == 2
    assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(tp))
