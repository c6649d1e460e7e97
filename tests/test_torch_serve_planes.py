"""The serving metric planes and node replacement of the port against the
JAX package and its NumPy golden model ``repro.oracle.kvpool``.

Every number here is an integer and is compared exactly: critical-word
latencies on random tables, and every plane and counter of a full run on
``bench_serve``'s schedule (16 requests x 16 tokens, 4 slots, page 4,
8 banks, a placement churn every 2 steps; benchmarks/bench_serve.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro.oracle import kvpool
from repro.runtime import kvbank as jkb
from repro.runtime import server as jserver
from repro_torch.configs.base import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.obs import serve as tobs
from repro_torch.runtime import kvbank as tkb
from repro_torch.runtime import server as tserver

BENCH = dict(n_slots=4, max_prompt=16, max_seq=64, max_new_tokens=16)
CHURN_EVERY = 2
SMALL = dict(n_slots=3, max_prompt=8, max_seq=24, max_new_tokens=5)


def _cfgs():
    # bench_serve's config: reduced qwen2.5-3b with page 4
    return tuple(dataclasses.replace(g("qwen2.5-3b").reduced(), kv_page=4)
                 for g in (jget_config, tget_config))


@pytest.fixture(scope="module")
def params():
    jc, tc = _cfgs()
    jp = jlm.init_params(jc, jax.random.key(0), max_seq=BENCH["max_seq"])
    return jp, params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")


def _bench_requests(server_mod, vocab, n=16, seed=0):
    """benchmarks/bench_serve.py::_requests."""
    rng = np.random.default_rng(seed)
    return [server_mod.Request(rid=i, prompt=[int(x) for x in rng.integers(
        1, max(vocab // 2, 2), size=4 + i % 9)]) for i in range(n)]


def _drive_bench(srv, reqs, seed=0, churn=True):
    """bench_serve's metrics run on either package's server: admit, churn
    every 2 steps, replay each step in the oracle, decode. Returns the
    oracle totals and the tokens."""
    churn_rng = np.random.default_rng(seed)
    totals = kvpool.plane_totals(srv.kvcfg.n_banks)
    for r in reqs:
        srv.submit(r)
    step = 0
    while True:
        srv._admit()
        if not any(s is not None for s in srv.slots):
            break
        if churn and step and step % CHURN_EVERY == 0:
            srv.permute_pool(churn_rng.permutation(srv.kvcfg.pool_pages))
        pool = srv.cache["pool"]
        pt, ln = np.asarray(pool.page_table), np.asarray(pool.length)
        fresh = np.asarray(pool.parity_fresh) \
            if pool.parity_fresh.shape[0] else None     # uncoded pool
        active = (pt[:, 0] >= 0) & (ln > 0)
        totals.add(kvpool.expected_step(srv.kvcfg.n_banks, srv.kvcfg.page,
                                        pt, ln, fresh, active,
                                        srv.sc.recode_budget))
        srv.step_decode()
        step += 1
    return totals, [r.out for r in reqs]


# ------------------------------------------------------------ latencies
def _random_tables(rng, cfgk):
    b = int(rng.integers(2, 6))
    length = rng.integers(0, cfgk.max_pages * cfgk.page, size=b)
    n_pages = [kvpool.ceil_div(int(x), cfgk.page) for x in length]
    phys = rng.choice(cfgk.pool_pages, size=sum(n_pages), replace=False)
    table = np.full((b, cfgk.max_pages), -1, np.int64)
    c = 0
    for i, n in enumerate(n_pages):
        table[i, :n] = phys[c:c + n]
        c += n
    fresh = rng.random((cfgk.n_banks // 2,
                        cfgk.pool_pages // cfgk.n_banks)) < 0.8
    return table, length, fresh


@pytest.mark.parametrize("trial", range(8))
def test_read_latencies_match_jax_and_oracle(trial):
    """As tests/test_serve.py:155: the plan and the per-page critical-word
    latencies on random tables equal JAX's and the oracle's, and the
    slowest critical word is the plan's coded port cycles."""
    rng = np.random.default_rng(trial)
    kw = dict(n_banks=8, page=4, pool_pages=64, max_pages=6)
    jcfg, tcfg = jkb.KVBankConfig(**kw), tkb.KVBankConfig(**kw)
    table, length, fresh = _random_tables(rng, tcfg)
    exp = kvpool.plan_reads(8, 4, table, length, fresh)
    pt, ln = table.astype(np.int32), length.astype(np.int32)
    tplan = tkb._plan_from_tables(tcfg, torch.from_numpy(pt),
                                  torch.from_numpy(ln),
                                  torch.from_numpy(fresh))
    np.testing.assert_array_equal(tplan.use_parity.numpy(), exp["use_parity"])
    for up in (tplan.use_parity, torch.zeros_like(tplan.use_parity)):
        lat = tkb.read_latencies(tcfg, torch.from_numpy(pt),
                                 torch.from_numpy(ln), up)
        assert lat.dtype == torch.int32
        jlat = jkb.read_latencies(jcfg, jnp.asarray(pt), jnp.asarray(ln),
                                  jnp.asarray(up.numpy()))
        olat = kvpool.read_latencies(8, 4, table, length, up.numpy())
        np.testing.assert_array_equal(lat.numpy(), np.asarray(jlat))
        np.testing.assert_array_equal(lat.numpy(), olat)
    lat = tkb.read_latencies(tcfg, torch.from_numpy(pt),
                             torch.from_numpy(ln), tplan.use_parity)
    if lat.max() > 0:
        assert int(lat.max()) == int(tplan.coded_cycles) \
            == exp["coded_cycles"]


def test_lat_bin_matches_jax_planes():
    from repro.obs.planes import lat_bin as jlat_bin
    lat = np.concatenate([np.arange(70), [127, 128, 2**14, 2**15, 2**20]])
    np.testing.assert_array_equal(
        tobs.lat_bin(torch.from_numpy(lat)).numpy(),
        np.asarray(jlat_bin(jnp.asarray(lat, jnp.int32))))


# ------------------------------------------------- planes on bench_serve
@pytest.fixture(scope="module")
def bench_runs(params):
    jp, tp = params
    jc, tc = _cfgs()
    jsrv = jserver.Server(jc, jserver.ServeConfig(**BENCH, telemetry=True),
                          jp)
    jtot, jtok = _drive_bench(jsrv, _bench_requests(jserver, jc.vocab))
    tsrv = tserver.Server(tc, tserver.ServeConfig(**BENCH, telemetry=True),
                          tp, device="cpu")
    ttot, ttok = _drive_bench(tsrv, _bench_requests(tserver, tc.vocab))
    return (jsrv, jtot, jtok), (tsrv, ttot, ttok)


def test_planes_equal_the_oracle_totals(bench_runs):
    _, (tsrv, ttot, _) = bench_runs
    snap = tsrv.serve_snapshot()
    snap.check_against(ttot)
    assert snap.decode_steps > 0 and snap.degraded_reads > 0
    assert snap.direct_reads + snap.degraded_reads == snap.served_pages
    assert snap.coded_cycles < snap.uncoded_cycles


def test_planes_equal_the_jax_server_planes(bench_runs):
    (jsrv, jtot, _), (tsrv, ttot, _) = bench_runs
    jd, td = jsrv.serve_snapshot().as_dict(), tsrv.serve_snapshot().as_dict()
    assert jd.keys() == td.keys()
    for k in jd:
        np.testing.assert_array_equal(np.asarray(td[k]), np.asarray(jd[k]),
                                      err_msg=k)
    # both replays of the oracle saw the same tables
    for f in ("bank_load_hist", "read_mode_bank", "port_lat_hist"):
        np.testing.assert_array_equal(getattr(ttot, f), getattr(jtot, f))


def test_format_summary_reports_the_planes(bench_runs):
    _, (tsrv, _, _) = bench_runs
    snap = tsrv.serve_snapshot()
    text = tobs.format_summary(snap)
    assert f"coded {snap.coded_cycles} vs uncoded {snap.uncoded_cycles}" \
        in text
    assert f"({snap.degraded_reads} degraded)" in text


@pytest.mark.parametrize("kw", [dict(), dict(recode_budget=2),
                                dict(recode_budget=-1), dict(coded=False)],
                         ids=["fused", "budget2", "never_recode", "uncoded"])
def test_planes_match_oracle_per_pool_variant(params, kw):
    _, tp = params
    _, tc = _cfgs()
    srv = tserver.Server(tc, tserver.ServeConfig(**SMALL, telemetry=True,
                                                 **kw), tp, device="cpu")
    reqs = _bench_requests(tserver, tc.vocab, n=6, seed=3)
    # no churn without a recode: permute_pool rebuilds the parity of the
    # data it moves
    never = kw.get("recode_budget") == -1
    totals, _ = _drive_bench(srv, reqs, seed=3, churn=not never)
    snap = srv.serve_snapshot()
    snap.check_against(totals)
    if never or kw.get("coded") is False:
        # stale parity is never read, and an uncoded pool has none
        assert snap.degraded_reads == 0
        assert snap.coded_cycles == snap.uncoded_cycles


# --------------------------------------------------------- observer only
def _serve(srv, reqs, permute_seed=None):
    for r in reqs:
        srv.submit(r)
    rng = np.random.default_rng(permute_seed)
    for step in range(400):
        srv._admit()
        if not any(s is not None for s in srv.slots):
            break
        if permute_seed is not None and step % 2 == 1:
            srv.permute_pool(rng.permutation(srv.kvcfg.pool_pages))
        srv.step_decode()
    return srv


def test_telemetry_is_observer_only(params):
    """Planes on or off: the same tokens, the same pool bit for bit."""
    _, tp = params
    _, tc = _cfgs()
    runs = []
    for tele in (False, True):
        srv = tserver.Server(tc, tserver.ServeConfig(**SMALL, telemetry=tele),
                             tp, device="cpu")
        reqs = _bench_requests(tserver, tc.vocab, n=5, seed=1)
        _serve(srv, reqs, permute_seed=4)
        runs.append((srv, [r.out for r in reqs]))
    (off, tok_off), (on, tok_on) = runs
    assert tok_off == tok_on
    assert off.cache["tele"] is None and off.serve_snapshot() is None
    assert on.serve_snapshot().degraded_reads > 0
    for f in dataclasses.fields(off.cache["pool"]):
        assert torch.equal(getattr(off.cache["pool"], f.name),
                           getattr(on.cache["pool"], f.name)), f.name


# -------------------------------------------------- node replacement
def _finish(srv):
    for _ in range(400):
        srv.step()
        if not srv.queue and all(s is None for s in srv.slots):
            break


def _replace_midstream(make_server, reqs, steps=3):
    srv_a = make_server()
    for r in reqs:
        srv_a.submit(r)
    for _ in range(steps):
        srv_a.step()
    snap = srv_a.snapshot()
    queue = [(r.rid, list(r.prompt), list(r.out)) for r in srv_a.queue]
    srv_b = make_server()
    srv_b.restore_snapshot(snap)
    srv_b.queue = [tserver.Request(rid=q[0], prompt=q[1], out=q[2])
                   for q in queue]
    return srv_a, srv_b, snap


@pytest.mark.parametrize("backend", ["pool", "ring"])
def test_node_replacement_midstream(params, backend):
    """As tests/test_serve.py:193: snapshot mid-decode, restore into a
    fresh server, finish on both: tokens, every cache tensor, the planes
    and the page accounting stay identical; the snapshot itself is not
    altered by the steps taken after it."""
    _, tp = params
    _, tc = _cfgs()
    if backend == "ring":
        tc = dataclasses.replace(tc, kv_banks=0)
    sc = tserver.ServeConfig(**SMALL, telemetry=True)
    reqs = _bench_requests(tserver, tc.vocab, n=5, seed=2)
    srv_a, srv_b, snap = _replace_midstream(
        lambda: tserver.Server(tc, sc, tp, device="cpu"), reqs)
    frozen = jax.tree.map(np.copy, snap)
    moved = [r for r in srv_b.slots if r] + srv_b.queue
    _finish(srv_a)
    _finish(srv_b)
    # the requests that moved finish on node b with node a's tokens
    by_rid = {r.rid: r.out for r in reqs}
    assert moved and all(r.out == by_rid[r.rid] for r in moved)
    for a, b in zip(jax.tree.leaves(snap), jax.tree.leaves(frozen)):
        np.testing.assert_array_equal(a, b)
    ha = tserver._to_host(srv_a.cache)
    hb = tserver._to_host(srv_b.cache)
    assert jax.tree.structure(ha) == jax.tree.structure(hb)
    for a, b in zip(jax.tree.leaves(ha), jax.tree.leaves(hb)):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(srv_a.tokens, srv_b.tokens)
    outs_a = [r.out for r in reqs]
    assert all(len(o) == SMALL["max_new_tokens"] for o in outs_a)
    if backend == "pool":
        assert srv_a.free_pages == srv_b.free_pages
        assert srv_a.serve_snapshot().as_dict() == \
            srv_b.serve_snapshot().as_dict()
    else:
        assert srv_b.serve_snapshot() is None
