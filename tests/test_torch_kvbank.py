"""The port's coded KV page pool ops against the JAX package's, bit for
bit: the same uint16 lane bits and tables go through each op in both
packages and every pool leaf is compared. Plans are also held against the
NumPy golden model ``repro.oracle.kvpool``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.oracle import kvpool
from repro.runtime import kvbank as jkb
from repro_torch.runtime import kvbank as tkb

L, NB, SLOTS, PAGE, HKV, D, B, MP = 2, 8, 4, 4, 2, 8, 4, 3
FIELDS = ("k_banks", "v_banks", "k_par", "v_par", "parity_fresh",
          "page_table", "length")


def _cfgs():
    kw = dict(n_banks=NB, page=PAGE, pool_pages=NB * SLOTS, max_pages=MP)
    return jkb.KVBankConfig(**kw), tkb.KVBankConfig(**kw)


def _np_pool(seed, coded=True, consistent=False):
    """Random lane bits, page-table rows of distinct pages (one free
    slot), lengths anywhere in the rows, a random status table."""
    rng = np.random.default_rng(seed)
    ng = NB // 2 if coded else 0
    shape = (L, NB, SLOTS, PAGE, HKV, D)

    def bits(s):
        return rng.integers(0, 2 ** 16, size=s, dtype=np.uint16)

    kb, vb = bits(shape), bits(shape)
    if consistent:
        kp, vp = (kb[:, 0::2] ^ kb[:, 1::2])[:, :ng], \
            (vb[:, 0::2] ^ vb[:, 1::2])[:, :ng]
    else:
        kp, vp = bits((L, ng) + shape[2:]), bits((L, ng) + shape[2:])
    phys = rng.permutation(NB * SLOTS)[: B * MP].reshape(B, MP)
    pt = phys.astype(np.int32)
    length = rng.integers(1, MP * PAGE + 1, size=B).astype(np.int32)
    pt[1] = -1
    length[1] = 0
    fresh = rng.random((ng, SLOTS)) < 0.7
    return dict(k_banks=kb, v_banks=vb, k_par=kp, v_par=vp,
                parity_fresh=fresh, page_table=pt, length=length)


def _jax(d):
    return jkb.PooledKV(**{k: jnp.asarray(v) for k, v in d.items()})


def _signed(a):
    """A torch copy of ``a`` (the port's ops write in place)."""
    a = np.array(a, copy=True)
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


def _torch(d):
    return tkb.PooledKV(**{k: _signed(v) for k, v in d.items()})


def _bits(a):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.uint16) if a.dtype == np.int16 else a


def assert_same(x, y):
    x, y = _bits(x), _bits(y)
    assert x.shape == y.shape
    np.testing.assert_array_equal(x, y)


def assert_pool_equal(jp, tp):
    for f in FIELDS:
        assert_same(getattr(tp, f), getattr(jp, f))


def _active(d):
    return (d["page_table"][:, 0] >= 0) & (d["length"] > 0)


@pytest.mark.parametrize("seed", range(4))
def test_pool_write_index_and_mark_stale(seed):
    jc, tc = _cfgs()
    d = _np_pool(seed)
    d["length"][0] = MP * PAGE        # table exhausted: a dead lane
    act = _active(d)
    jp, tp = _jax(d), _torch(d)
    jw = jkb.pool_write_index(jc, jp, jnp.asarray(act))
    tw = tkb.pool_write_index(tc, tp, torch.from_numpy(act))
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(tw[0][0]) == NB and int(tw[0][1]) == NB
    assert_pool_equal(jkb.pool_mark_stale(jc, jp, jw),
                      tkb.pool_mark_stale(tc, tp, tw))


@pytest.mark.parametrize("seed,coded", [(s, c) for s in range(4)
                                        for c in (True, False)])
def test_pool_plan_matches_jax_and_oracle(seed, coded):
    jc, tc = _cfgs()
    d = _np_pool(seed, coded=coded)
    jplan = jkb.pool_plan(jc, _jax(d))
    tplan = tkb.pool_plan(tc, _torch(d))
    for f in ("use_parity", "load", "uncoded_cycles", "coded_cycles"):
        np.testing.assert_array_equal(getattr(tplan, f).numpy(),
                                      np.asarray(getattr(jplan, f)))
    exp = kvpool.plan_reads(NB, PAGE, d["page_table"], d["length"],
                            d["parity_fresh"] if coded else None)
    np.testing.assert_array_equal(tplan.use_parity.numpy(), exp["use_parity"])
    np.testing.assert_array_equal(tplan.load.numpy(), exp["load"])
    assert int(tplan.uncoded_cycles) == exp["uncoded_cycles"]
    assert int(tplan.coded_cycles) == exp["coded_cycles"]
    if not coded:
        assert not tplan.use_parity.any()


def _step_write_inputs(seed, d):
    jc, tc = _cfgs()
    act = _active(d)
    rng = np.random.default_rng(100 + seed)
    k_new = rng.integers(0, 2 ** 16, size=(B, HKV, D), dtype=np.uint16)
    v_new = rng.integers(0, 2 ** 16, size=(B, HKV, D), dtype=np.uint16)
    jw = jkb.pool_write_index(jc, _jax(d), jnp.asarray(act))
    tw = tkb.pool_write_index(tc, _torch(d), torch.from_numpy(act))
    return jc, tc, jw, tw, k_new, v_new


@pytest.mark.parametrize("seed", range(4))
def test_pool_write_layer_matches_jax(seed):
    d = _np_pool(seed)
    jc, tc, jw, tw, k_new, v_new = _step_write_inputs(seed, d)
    jk, jv = jkb.pool_write_layer(jc, jnp.asarray(d["k_banks"][1]),
                                  jnp.asarray(d["v_banks"][1]), jw,
                                  jnp.asarray(k_new), jnp.asarray(v_new))
    tk, tv = _signed(d["k_banks"][1]), _signed(d["v_banks"][1])
    tkb.pool_write_layer(tc, tk, tv, tkb.write_lanes(tc, tw),
                         _signed(k_new), _signed(v_new))
    assert_same(tk, jk)
    assert_same(tv, jv)


@pytest.mark.parametrize("seed", range(4))
def test_pool_write_layer_fused_matches_jax_and_recode(seed):
    """Encode-on-write equals the JAX op bit for bit, and on a pool with
    consistent parity it equals write-then-full-recode."""
    d = _np_pool(seed, consistent=True)
    jc, tc, jw, tw, k_new, v_new = _step_write_inputs(seed, d)
    lay = {f: d[f][0] for f in ("k_banks", "v_banks", "k_par", "v_par")}
    jout = jkb.pool_write_layer_fused(
        jc, *(jnp.asarray(lay[f]) for f in ("k_banks", "v_banks", "k_par",
                                            "v_par")),
        jw, jnp.asarray(k_new), jnp.asarray(v_new))
    tout = [_signed(lay[f]) for f in ("k_banks", "v_banks", "k_par", "v_par")]
    tkb.pool_write_layer_fused(tc, *tout, tkb.write_lanes(tc, tw),
                               _signed(k_new), _signed(v_new))
    for t, j in zip(tout, jout):
        assert_same(t, j)
    tk, tv, tkp, tvp = tout
    assert torch.equal(tkp, tk[0::2] ^ tk[1::2])
    assert torch.equal(tvp, tv[0::2] ^ tv[1::2])


@pytest.mark.parametrize("fuse,coded", [(True, True), (False, True),
                                        (False, False)])
def test_pool_install_matches_jax(fuse, coded):
    jc, tc = _cfgs()
    d = _np_pool(5, coded=coded)
    rng = np.random.default_rng(6)
    t_len = MP * PAGE - 2                    # a partly filled last page
    k_seq = rng.integers(0, 2 ** 16, size=(L, t_len, HKV, D), dtype=np.uint16)
    v_seq = rng.integers(0, 2 ** 16, size=(L, t_len, HKV, D), dtype=np.uint16)
    jp = jkb.pool_install(jc, _jax(d), 2, jnp.asarray(k_seq),
                          jnp.asarray(v_seq), fuse_encode=fuse)
    tp = tkb.pool_install(tc, _torch(d), 2, _signed(k_seq), _signed(v_seq),
                          fuse_encode=fuse)
    assert_pool_equal(jp, tp)
    assert int(tp.length[2]) == t_len


@pytest.mark.parametrize("budget", [None, 2, -1, 100])
def test_pool_recode_matches_jax(budget):
    jc, tc = _cfgs()
    d = _np_pool(7)
    jp, jn = jkb.pool_recode(jc, _jax(d), budget=budget)
    tp, tn = tkb.pool_recode(tc, _torch(d), budget=budget)
    assert_pool_equal(jp, tp)
    assert int(tn) == int(jn)


def test_pool_recode_budget_takes_first_stale_rows():
    _, tc = _cfgs()
    d = _np_pool(8)
    tp, n = tkb.pool_recode(tc, _torch(d), budget=3)
    take = kvpool.recode_select(d["parity_fresh"], 3)
    np.testing.assert_array_equal(tp.parity_fresh.numpy(),
                                  d["parity_fresh"] | take)
    assert int(n) == int(take.sum())


@pytest.mark.parametrize("coded", [True, False])
def test_pool_permute_matches_jax(coded):
    jc, tc = _cfgs()
    d = _np_pool(9, coded=coded)
    perm = np.random.default_rng(10).permutation(NB * SLOTS)
    jp = jkb.pool_permute(jc, _jax(d), jnp.asarray(perm, jnp.int32))
    pool = _torch(d)
    before = {f.name: getattr(pool, f.name).data_ptr()
              for f in dataclasses.fields(pool)}
    tp = tkb.pool_permute(tc, pool, torch.from_numpy(perm))
    assert_pool_equal(jp, tp)
    assert tp.k_banks.is_contiguous()
    # in place: a caller holding the pool's tensors sees the moved pages
    assert {f.name: getattr(tp, f.name).data_ptr()
            for f in dataclasses.fields(tp)} == before


def test_pool_init_matches_jax():
    jc, tc = _cfgs()
    for coded in (True, False):
        jp = jkb.pool_init(jc, L, B, HKV, D, jnp.bfloat16, coded=coded)
        tp = tkb.pool_init(tc, L, B, HKV, D, torch.bfloat16, device="cpu",
                           coded=coded)
        assert_pool_equal(jp, tp)
        assert tkb.pool_coded(tp) == coded
        assert dataclasses.is_dataclass(tp)


# --------------------------------------------------- per-sequence state API
STATE_FIELDS = ("k_banks", "v_banks", "k_par", "v_par", "parity_fresh",
                "page_table", "length", "next_page")
# name: (pool pages, table width, steps): "past_the_table" appends past
# max_pages * page tokens (JAX drops those table writes and clamps the
# table reads); "past_the_pool" allocates past the pool's last page (JAX
# drops those token writes and clamps the slot of the plan's and the
# gather's reads)
STATE_CASES = {"churned": (64, 6, 20), "past_the_table": (64, 4, 20),
               "past_the_pool": (16, 16, 40)}


def assert_state_equal(js, ts):
    for f in STATE_FIELDS:
        assert_same(getattr(ts, f), getattr(js, f))


@pytest.mark.parametrize("case", sorted(STATE_CASES))
@pytest.mark.parametrize("budget", [None, 2])
def test_banked_state_matches_jax(case, budget):
    """``init_state`` then a churned append sequence (a random active set
    each step, so sequences cross page boundaries at different steps and
    their pages interleave in the pool), recoding every third step with
    ``budget``: every leaf, the read plan and the ``gather_kv`` output
    equal JAX's bit for bit after every step."""
    pool_pages, mp, steps = STATE_CASES[case]
    kw = dict(n_banks=NB, page=PAGE, pool_pages=pool_pages, max_pages=mp)
    jc, tc = jkb.KVBankConfig(**kw), tkb.KVBankConfig(**kw)
    js = jkb.init_state(jc, B, HKV, D, jnp.bfloat16)
    ts = tkb.init_state(tc, B, HKV, D, torch.bfloat16, device="cpu")
    assert_state_equal(js, ts)
    # served churn first (as benchmarks/bench_kvbank.py models it): the
    # live pages sit on random physical pages at the top of the pool, so
    # the banks are loaded unevenly and the plan serves degraded reads
    rng = np.random.default_rng(11)
    length = rng.integers(0, 2 * PAGE + 1, size=B).astype(np.int32)
    n_live = -(-length // PAGE)
    top = rng.permutation(np.arange(pool_pages // 2, pool_pages))
    table = np.full((B, mp), -1, np.int32)
    for i, c in enumerate(np.cumsum(n_live) - n_live):
        table[i, :n_live[i]] = top[c:c + n_live[i]]
    js = js._replace(page_table=jnp.asarray(table), length=jnp.asarray(length))
    ts.page_table.copy_(torch.from_numpy(table))
    ts.length.copy_(torch.from_numpy(length))
    n_degraded = 0
    for step in range(steps):
        k = rng.integers(0, 2 ** 16, size=(B, HKV, D), dtype=np.uint16)
        v = rng.integers(0, 2 ** 16, size=(B, HKV, D), dtype=np.uint16)
        act = rng.random(B) < 0.75
        kj, vj = (jnp.asarray(x).view(jnp.bfloat16) for x in (k, v))
        js = jkb.append_token(jc, js, kj, vj, jnp.asarray(act))
        out = tkb.append_token(tc, ts, _signed(k).view(torch.bfloat16),
                               _signed(v).view(torch.bfloat16),
                               torch.from_numpy(act))
        assert out is ts                       # in place
        if step % 3 == 2:
            js = jkb.recode(jc, js, budget=budget)
            tkb.recode(tc, ts, budget=budget)
        assert_state_equal(js, ts)
        jplan, tplan = jkb.plan_reads(jc, js), tkb.plan_reads(tc, ts)
        for f in ("use_parity", "load", "uncoded_cycles", "coded_cycles"):
            np.testing.assert_array_equal(getattr(tplan, f).numpy(),
                                          np.asarray(getattr(jplan, f)))
        n_degraded += int(tplan.use_parity.sum())
        jk, jv = jkb.gather_kv(jc, js, jplan, jnp.bfloat16)
        tk, tv = tkb.gather_kv(tc, ts, tplan, torch.bfloat16)
        assert_same(tk.view(torch.int16), np.asarray(jk).view(np.uint16))
        assert_same(tv.view(torch.int16), np.asarray(jv).view(np.uint16))
    assert n_degraded > 0, "no degraded read planned"
    if case == "past_the_pool":
        assert int(ts.next_page) > pool_pages, "the pool was not exhausted"
