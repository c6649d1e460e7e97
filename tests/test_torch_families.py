"""The MoE and vision-prefix families of the port against the JAX package
on the CPU: ``models/moe.py``'s block; the three configs the port now
serves, reduced: olmoe-1b-7b (MoE, the coded KV page pool), mixtral-8x7b
(MoE, a sliding window of 16: the ring cache) and phi-3-vision-4.2b (the
dense stack behind the vision stub: the ring cache); and training them
through ``make_train_step``, the ``Trainer`` and the launcher
(``tests/test_torch_train_families.py`` holds the step against JAX).
JAX params are carried across by
``convert.params_from_jax``; JAX runs its plain paths (the ``reference``
pool gather).

Tolerances at f32: a MoE block's expert choices and keep mask identical,
its output within 1e-5 of its largest magnitude; logits rtol = atol =
1e-4 (the frameworks sum in different orders); served tokens identical.
The page tables, lengths, code-status table and read plans of a pool do
not depend on values and are compared exactly, at bf16 too. The K/V
banks of the two frameworks agree within the logits' tolerance; the
port's coded and uncoded pools hold the same banks bit for bit, and its
fresh parity rows are the XOR of their banks bit for bit."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.runtime import kvbank as jkb
from repro.runtime import server as jserver
from repro_torch.configs.base import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.launch import train as tlaunch_train
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.optim.adamw import OptConfig, adamw_init
from repro_torch.runtime import kvbank as tkb
from repro_torch.runtime import server as tserver
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime import trainer as ttrainer

TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = 1e-5                  # of the output's largest magnitude
FAMILIES = ("olmoe-1b-7b", "mixtral-8x7b", "phi-3-vision-4.2b")
# page 4 divides max_seq; mixtral's window of 16 fits max_prompt; phi's 8
# patch positions fit it
SC = {"olmoe-1b-7b": dict(n_slots=3, max_prompt=8, max_seq=24,
                          max_new_tokens=5),
      "mixtral-8x7b": dict(n_slots=3, max_prompt=16, max_seq=32,
                           max_new_tokens=6),
      "phi-3-vision-4.2b": dict(n_slots=3, max_prompt=12, max_seq=24,
                                max_new_tokens=5)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: one intra-op thread each keeps six test
    workers from oversubscribing the cores (torch starts one a core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, dtype="float32", **extra):
    return tuple(dataclasses.replace(g(name).reduced(), kv_page=4,
                                     compute_dtype=dtype, **extra)
                 for g in (jget_config, tget_config))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=FAMILIES)
def params(request):
    name = request.param
    jc, tc = _cfgs(name)
    jp = jlm.init_params(jc, jax.random.key(0), max_seq=48)
    return name, jp, params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")


# ---------------------------------------------------------------- configs
def test_configs_copy_jax():
    """Every field the port's config shares with JAX's has JAX's value,
    full and reduced (the MoE and patch cuts included)."""
    for name in FAMILIES:
        for j, t in ((jget_config(name), tget_config(name)),
                     (jget_config(name).reduced(),
                      tget_config(name).reduced())):
            for f in dataclasses.fields(t):
                assert getattr(t, f.name) == getattr(j, f.name), (name,
                                                                  f.name)
    olmoe = tget_config("olmoe-1b-7b")
    assert (olmoe.n_experts, olmoe.top_k, olmoe.moe_group) == (64, 8, 2048)
    red = tget_config("phi-3-vision-4.2b").reduced()
    assert (red.n_patches, red.frontend) == (8, "vision_stub")


def test_params_from_jax_carries_every_leaf(params):
    """The ``moe`` subtree (router, w_up, w_down, w_gate) and the vlm tree
    carried leaf for leaf, bit for bit."""
    name, jp, tp = params
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(jax.tree_util.tree_leaves(tp))
    for path, a in jleaves:
        node = tp
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(a))
    blocks = tp["blocks"]
    if name == "phi-3-vision-4.2b":
        assert "mlp" in blocks and "moe" not in blocks
    else:
        assert sorted(blocks["moe"]) == ["router", "w_down", "w_gate",
                                         "w_up"]
        assert "mlp" not in blocks


def test_port_init_has_jax_shapes(params):
    """The port's own init draws JAX's leaves with JAX's shapes."""
    name, jp, _ = params
    tc = _cfgs(name)[1]
    tp = tlm.init_params(tc, seed=1, device="cpu", dtype=torch.float32)
    want = {jax.tree_util.keystr(p): a.shape
            for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    got = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + f"[{k!r}]")
        else:
            got[path] = tuple(node.shape)
    walk(tp, "")
    assert got == want


# ------------------------------------------------------------- moe_block
@functools.partial(jax.jit, static_argnums=0)
def _jax_moe(cfg, p, x):
    """JAX's block and its routing (``repro`` moe.py:45-58): the output,
    the experts chosen and the keep mask, each (ng, g, k)."""
    b, t, d = x.shape
    g = min(cfg.moe_group, b * t)
    cap = max(1, int(g * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    logits = jnp.einsum("ngd,de->nge", x.reshape(-1, g, d),
                        p["router"]).astype(jnp.float32)
    _, idx = jax.lax.top_k(logits, cfg.top_k)
    onehot = jax.nn.one_hot(idx, cfg.n_experts, dtype=jnp.float32)
    flat = onehot.reshape(idx.shape[0], -1, cfg.n_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    keep = (onehot * (pos < cap)).sum(-1) > 0
    return jmoe.moe_block(cfg, p, x), idx, keep


def _moe_case(case):
    """(config name, fields, JAX moe params, x (B, T, D) f32) of a case."""
    rng = np.random.default_rng(11)
    if case == "olmoe_drops":
        # 64 experts top-8 cut to 16 top-4: a 12-slot decode group, cap 3
        name, extra, shape = "olmoe-1b-7b", dict(n_experts=16, top_k=4), \
            (12, 1)
    elif case == "mixtral_groups":
        # two groups of 64 (reduced moe_group), cap 40
        name, extra, shape = "mixtral-8x7b", {}, (2, 64)
    else:
        name, extra, shape = "olmoe-1b-7b", {}, (1, 8)
    jc, tc = _cfgs(name, **extra)
    p = jmoe.moe_init(jc, jax.random.key(3), jnp.float32)
    p = {k: np.array(v) for k, v in p.items()}
    x = rng.normal(size=shape + (jc.d_model,)).astype(np.float32)
    if case == "ties":
        # duplicate router columns: experts 1 and 2 copy 0, and every
        # token leans towards that column, so 0, 1, 2 tie exactly on top
        p["router"][:, 1] = p["router"][:, 0]
        p["router"][:, 2] = p["router"][:, 0]
        x = np.abs(x) * np.sign(p["router"][:, 0])
    elif case == "priority":
        # every token prefers expert 0 then 1: with cap 5 of 8 tokens,
        # tokens 0..4 keep their first choice and 5..7 drop it
        p["router"][:, 0] = 0
        p["router"][:, 1] = 0
        p["router"][0, :] = 0
        p["router"][0, 0], p["router"][0, 1] = 5.0, 4.0
        x[..., 0] = 1.0 + np.arange(8)[None, :] * 1e-3
    elif case == "padding":
        # a left-padded prompt of 16 (cap 10): ten pad rows ahead of six
        # real ones, the pads' hidden state routed as the last real row's;
        # routed first, the pads fill both of its experts
        x = rng.normal(size=(1, 16, jc.d_model)).astype(np.float32)
        x[:, :10] = x[:, 15:]
    return jc, tc, p, x


MOE_CASES = ("olmoe_drops", "mixtral_groups", "ties", "priority", "padding")


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_block_matches_jax(case):
    """Expert choices and drops identical to JAX's, outputs within 1e-5
    of the largest magnitude, in each case: a batch that drops; two
    dispatch groups; exact router ties (the lower index wins); a drop
    that token-major priority decides; left-pad rows that take capacity."""
    jc, tc, p, x = _moe_case(case)
    tp = {k: _t(v) for k, v in p.items()}
    want, jidx, jkeep = (np.asarray(a) for a in _jax_moe(
        jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = tmoe.moe_block(tc, tp, _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MOE_TOL * np.abs(want).max())
    _, _, cap = tmoe.groups(tc, x.shape[0] * x.shape[1])
    logits = tmoe.router_logits(tc, tp, _t(x))
    r = tmoe.route(tc, logits, cap)
    np.testing.assert_array_equal(r.idx.numpy(), jidx)
    np.testing.assert_array_equal(r.keep.numpy(), jkeep)
    if case == "olmoe_drops":
        assert cap == 3 and not jkeep.all()
    elif case == "ties":
        lg = logits.numpy()
        assert (lg[..., 0] == lg[..., 1]).all() and \
            (lg[..., 0] == lg[..., 2]).all()
        assert (r.idx[..., :2] == torch.tensor([0, 1])).all()
    elif case == "priority":
        assert cap == 5
        np.testing.assert_array_equal(r.idx.numpy()[0, :, 0], 0)
        np.testing.assert_array_equal(r.keep.numpy()[0, :, 0],
                                      [1] * 5 + [0] * 3)
    elif case == "padding":
        assert cap == 10
        np.testing.assert_array_equal(r.keep.numpy()[0, 15], [0, 0])
        # without the pads no real row would drop
        assert tmoe.route(tc, logits[:, 10:], cap).keep.all()


def test_moe_block_refuses_a_ragged_group():
    """JAX asserts B*T % g == 0; the port raises."""
    _, tc = _cfgs("mixtral-8x7b")
    p = tmoe.moe_init(tc, torch.Generator().manual_seed(0), torch.float32)
    with pytest.raises(ValueError, match="MoE group"):
        tmoe.moe_block(tc, p, torch.zeros(1, 65, tc.d_model))


# --------------------------------------------------------------- logits
def test_prefill_and_ring_decode_logits_match_jax(params):
    """Prefill (phi-3-vision's with random patches) and ring decode steps:
    logits within 1e-4, K/V too, the same greedy tokens."""
    name, jp, tp = params
    jc, tc = _cfgs(name)
    tpc = tlm.cast_params(tc, tp, "cpu")
    rng = np.random.default_rng(4)
    s = SC[name]["max_prompt"]
    toks = rng.integers(0, 256, size=(2, s))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    patches = None
    if name == "phi-3-vision-4.2b":
        patches = rng.normal(size=(2, jc.n_patches, jc.d_model)) \
            .astype(np.float32)
        jb["patches"] = jnp.asarray(patches)
        patches = _t(patches)
    jl, jcache = jlm.prefill(jc, jp, jb, max_seq=32)
    tl, tcache = tlm.prefill(tc, tpc, _t(toks), max_seq=32, patches=patches)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for f in ("k", "v"):
        np.testing.assert_allclose(tcache[f].numpy(), np.asarray(jcache[f]),
                                   **TOL)
    if patches is not None:
        plain, _ = tlm.prefill(tc, tpc, _t(toks), max_seq=32)
        assert not torch.allclose(plain, tl), "the patches changed nothing"
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = torch.argmax(tl, -1)
    jstep = jax.jit(lambda p, t, c: jlm.decode_step(jc, p, t, c))
    for _ in range(3):
        jl, jcache = jstep(jp, jtok, jcache)
        tl, tcache = tlm.decode_step(tc, tpc, ttok, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_prefill_refuses_a_prompt_shorter_than_the_patches():
    _, tc = _cfgs("phi-3-vision-4.2b")
    tp = tlm.init_params(tc, seed=0, device="cpu")
    with pytest.raises(ValueError, match="patch"):
        tlm.prefill(tc, tp, torch.zeros(1, 4, dtype=torch.long),
                    patches=torch.zeros(1, tc.n_patches, tc.d_model))


# ------------------------------------------------------------ the server
def _reqs(mod, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=[int(x) for x in rng.integers(
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


def _jax_step(srv, logits=True):
    """JAX's plan of the coming step and its logits."""
    pool = srv.cache["pool"]
    active = (pool.page_table[:, 0] >= 0) & (pool.length > 0)
    widx = jkb.pool_write_index(srv.kvcfg, pool, active)
    staled = jkb.pool_mark_stale(srv.kvcfg, pool, widx)
    plan = np.asarray(jkb.pool_plan(srv.kvcfg, staled,
                                    length=pool.length + active).use_parity)
    if not logits:
        return plan, None
    out, _, _ = jlm.decode_step_pooled(
        srv.cfg, srv.kvcfg, srv.params, srv.tokens, pool, None)
    return plan, np.asarray(out)


def _port_step(srv, logits=True):
    pool = srv.cache["pool"]
    clone = tkb.PooledKV(**{f.name: getattr(pool, f.name).clone()
                            for f in dataclasses.fields(pool)})
    active = (clone.page_table[:, 0] >= 0) & (clone.length > 0)
    widx = tkb.pool_write_index(srv.kvcfg, clone, active)
    tkb.pool_mark_stale(srv.kvcfg, clone, widx)
    plan = tkb.pool_plan(srv.kvcfg, clone,
                         length=clone.length + active).use_parity.numpy()
    if not logits:
        return plan, None
    clone = tkb.PooledKV(**{f.name: getattr(pool, f.name).clone()
                            for f in dataclasses.fields(pool)})
    out, _, _ = tlm.decode_step_pooled(srv.cfg, srv.kvcfg, srv.params,
                                       srv.tokens, clone)
    return plan, out.numpy()


def _recorder(step_fn, first_logits: bool):
    """Every step's tables and plan; the first step's logits."""
    rec = {"tables": [], "plans": [], "logits": None}

    def on_step(step, srv):
        pool = srv.cache["pool"]
        rec["tables"].append({f: _np(getattr(pool, f)).copy() for f in
                              ("page_table", "length", "parity_fresh")})
        plan, logits = step_fn(srv, first_logits and step == 0)
        rec["plans"].append(plan)
        if logits is not None:
            rec["logits"] = logits
    return rec, on_step


def _assert_tables(jrec, trec):
    assert len(trec["tables"]) == len(jrec["tables"]) > 0
    for jt, tt in zip(jrec["tables"], trec["tables"]):
        for f in jt:
            np.testing.assert_array_equal(tt[f], jt[f])
    for jpl, tpl in zip(jrec["plans"], trec["plans"]):
        np.testing.assert_array_equal(tpl, jpl)
    assert any(p.any() for p in trec["plans"]), "no degraded read planned"


def _float_banks(pool):
    """The K/V banks as f32 (parity rows are bit patterns, not values:
    they are held against their banks instead)."""
    return [_np(getattr(pool, f)).view(np.float32)
            for f in ("k_banks", "v_banks")]


def _fresh_parity_is_xor(pool):
    fresh = pool.parity_fresh
    for banks, par in ((pool.k_banks, pool.k_par), (pool.v_banks,
                                                     pool.v_par)):
        same = ((banks[:, 0::2] ^ banks[:, 1::2]) == par) \
            .flatten(3).all(-1).all(0)
        assert bool((same | ~fresh).all())
    return int(fresh.sum())


def test_served_f32_matches_jax(params):
    """One JAX ``Server`` and the port's over one request stream (placement
    churned on the pool, so reads go degraded; 5 requests on 3 slots, so
    free slots are routed beside busy ones): tokens identical. On olmoe's
    pool also every step's tables and plan, the first step's logits (1e-4),
    the banks (1e-4) and the parity-fresh table; the port's uncoded pool
    serves the same tokens from bit-identical banks."""
    name, jp, tp = params
    jc, tc = _cfgs(name)
    sc = SC[name]
    jsrv = jserver.Server(jc, jserver.ServeConfig(**sc), jp)
    tsrv = tserver.Server(tc, tserver.ServeConfig(**sc), tp, device="cpu")
    assert jsrv.pooled == tsrv.pooled == (name == "olmoe-1b-7b")
    if not tsrv.pooled:
        assert _drive(tsrv, _reqs(tserver)) == _drive(jsrv, _reqs(jserver))
        return
    jrec, jhook = _recorder(_jax_step, True)
    trec, thook = _recorder(_port_step, True)
    jtok = _drive(jsrv, _reqs(jserver), jhook, permute_seed=5)
    ttok = _drive(tsrv, _reqs(tserver), thook, permute_seed=5)
    assert ttok == jtok
    assert all(len(t) == sc["max_new_tokens"] for t in ttok)
    _assert_tables(jrec, trec)
    np.testing.assert_allclose(trec["logits"], jrec["logits"], **TOL)
    jpool, tpool = jsrv.cache["pool"], tsrv.cache["pool"]
    np.testing.assert_array_equal(_np(tpool.parity_fresh),
                                  _np(jpool.parity_fresh))
    for a, b in zip(_float_banks(tpool), _float_banks(jpool)):
        np.testing.assert_allclose(a, b, **TOL)
    assert _fresh_parity_is_xor(tpool) > 0
    unc = tserver.Server(tc, tserver.ServeConfig(**sc, coded=False), tp,
                         device="cpu")
    assert _drive(unc, _reqs(tserver), permute_seed=5) == ttok
    upool = unc.cache["pool"]
    assert not tkb.pool_coded(upool)
    assert torch.equal(upool.k_banks, tpool.k_banks) and \
        torch.equal(upool.v_banks, tpool.v_banks)


def test_olmoe_bf16_pool_matches_jax():
    """At bf16 the integer tables and plans equal JAX's step for step, and
    the port's pool variants (uncoded, budgeted recode, another churn)
    serve the coded pool's tokens."""
    name = "olmoe-1b-7b"
    jc, tc = _cfgs(name, "bfloat16")
    jp = jlm.init_params(jc, jax.random.key(0), max_seq=48)
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    sc = SC[name]

    jrec, jhook = _recorder(_jax_step, False)
    trec, thook = _recorder(_port_step, False)
    jsrv = jserver.Server(jc, jserver.ServeConfig(**sc), jp)
    tsrv = tserver.Server(tc, tserver.ServeConfig(**sc), tp, device="cpu")
    _drive(jsrv, _reqs(jserver), jhook, permute_seed=5)
    coded = _drive(tsrv, _reqs(tserver), thook, permute_seed=5)
    _assert_tables(jrec, trec)
    for kw, seed in ((dict(coded=False), 5), (dict(recode_budget=2), 5),
                     ({}, 3)):
        srv = tserver.Server(tc, tserver.ServeConfig(**sc, **kw), tp,
                             device="cpu")
        assert _drive(srv, _reqs(tserver), permute_seed=seed) == coded


def test_vlm_server_gives_zero_patches_and_refuses_a_short_prompt():
    """The vision_stub server prefills with zero patches over the first
    n_patches positions (JAX's ``Server``) and refuses max_prompt <
    n_patches."""
    name = "phi-3-vision-4.2b"
    _, tc = _cfgs(name)
    tp = tlm.init_params(tc, seed=0, device="cpu")
    with pytest.raises(ValueError, match="patch positions"):
        tserver.Server(tc, tserver.ServeConfig(
            **dict(SC[name], max_prompt=tc.n_patches - 1)), tp, device="cpu")
    srv = tserver.Server(tc, tserver.ServeConfig(**SC[name]), tp,
                         device="cpu")
    seen = []
    step = srv.prefill

    def spy(params_, tokens, patches=None):
        seen.append(patches)
        return step(params_, tokens, patches)
    srv.prefill = spy
    srv.submit(tserver.Request(rid=0, prompt=[5, 6, 7]))
    srv._admit()
    (p,) = seen
    assert tuple(p.shape) == (1, tc.n_patches, tc.d_model)
    assert not p.any() and p.dtype == getattr(torch, tc.compute_dtype)


@pytest.mark.parametrize("name", FAMILIES)
def test_launch_serve_reduced_on_the_cpu(name, capsys):
    """``python -m repro_torch.launch.serve --arch <name> --reduced
    --device cpu`` serves every request."""
    tlaunch_serve.main(["--arch", name, "--reduced", "--device", "cpu",
                        "--requests", "3", "--slots", "2", "--max-new", "3",
                        "--max-prompt", "16", "--max-seq", "32"])
    out = capsys.readouterr().out
    store = "coded pool" if name == "olmoe-1b-7b" else "ring cache"
    assert "served 3 requests / 9 tokens" in out and store in out


def test_launch_serve_asks_for_the_patch_positions(capsys):
    with pytest.raises(SystemExit):
        tlaunch_serve.main(["--arch", "phi-3-vision-4.2b", "--reduced",
                            "--device", "cpu", "--max-prompt", "4"])
    assert "--max-prompt >= 8" in capsys.readouterr().err


# -------------------------------------------------------------- training
@pytest.mark.parametrize("name", ["olmoe-1b-7b", "phi-3-vision-4.2b"])
def test_training_refuses_moe_and_vlm(name, tmp_path):
    """The MoE and vision-prefix families train now (the test keeps the
    name it had while they were refused): ``make_train_step`` takes a
    step (phi's batch with patch embeddings), the ``Trainer`` and the
    launcher two steps each on tokens alone, as JAX's ``Trainer`` feeds
    them; every loss is finite and the launcher's falls from a
    checkpoint it restores."""
    _, tc = _cfgs(name)
    gen = torch.Generator().manual_seed(0)
    tp = tlm.init_params(tc, seed=0, device="cpu", dtype=torch.float32)
    batch = {"tokens": torch.randint(0, tc.vocab, (2, 16), generator=gen)}
    if tc.frontend == "vision_stub":
        batch["patches"] = torch.randn(2, tc.n_patches, tc.d_model,
                                       generator=gen)
    _, _, m = tsteps.make_train_step(tc, OptConfig())(
        tp, adamw_init(tp), batch)
    assert np.isfinite(float(m["loss"])) and float(m["lr_step"]) == 1
    tr = ttrainer.Trainer(tc, ttrainer.TrainConfig(
        steps=2, ckpt_every=0, ckpt_dir=str(tmp_path / "t"), global_batch=2,
        seq_len=16), device="cpu")
    assert np.isfinite(tr.run()["final_loss"])
    out = tlaunch_train.main(["--arch", name, "--reduced", "--device", "cpu",
                              "--steps", "2", "--batch", "2", "--seq", "16",
                              "--ckpt", str(tmp_path / "l"),
                              "--ckpt-every", "1", "--fail-at", "1"])
    assert np.isfinite(out["final_loss"])
    assert "restored step 1" in out["events"]
