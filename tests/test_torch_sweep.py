"""The port's point axis and batched sweep engine (``repro_torch.sweep``,
``CodedMemorySystem.cycle_batch``) on the CPU against the JAX package, bit
for bit: padded allocations and traced geometry, per-point initial states,
``run_batch``/``run_points`` against JAX's engine (every SimResult field and
every final state leaf) and against the port's looped ``simulate``, the
grid's partition, trace building and stacking, the batched kernel wrappers,
and that a batched cycle shares each kernel launch across its points.

The geometry is ``tests/test_sweep.py``'s at 64 rows (3 cores, length 12);
inputs are made with numpy from a seed and handed to both sides."""
import dataclasses
import importlib
import os

import jax
import numpy as np
import pytest
import torch
from conftest import rand_trace
from test_torch_sim import _jtrace_to_port

from repro.core import codes as jcodes
from repro.core import state as jstate
from repro.sweep import engine as jeng
from repro.sweep import workloads as jwork
from repro.traces.formats import save_npz
from repro_torch import convert
from repro_torch.core import codes, controller as ctl, state, system
from repro_torch.kernels.xor_encode import ops as enc_ops
from repro_torch.kernels.xor_encode.ref import encode_parities_plain
from repro_torch.kernels.xor_gather import ops as g_ops
from repro_torch.kernels.xor_gather.ref import gather_decode_plain
from repro_torch.launch import mesh
from repro_torch.sim import ramulator
from repro_torch.sweep import engine, workloads

# the packages export a ``grid`` function that shadows the module
jgrid = importlib.import_module("repro.sweep.grid")
tgrid = importlib.import_module("repro_torch.sweep.grid")
CPU = "cpu"
DATA = os.path.join(os.path.dirname(__file__), "data")
JBASE = jgrid.SweepPoint(scheme="scheme_i", alpha=0.25, r=0.125, n_rows=64,
                         n_cores=3, n_banks=8, length=12, select_period=4)


def _tpt(jpt) -> tgrid.SweepPoint:
    """The port's SweepPoint with every field of a JAX one."""
    return tgrid.SweepPoint(**{f.name: getattr(jpt, f.name)
                              for f in dataclasses.fields(jpt)})


def assert_states_equal(jst, tst, label=""):
    """Every leaf of a (batched) JAX SimState equals the port's, dtypes
    included (wide counters through ``convert``'s (lo, hi) pairs, the
    telemetry planes leaf by leaf)."""
    host = jax.device_get(jst)
    port = convert.sim_state_to_numpy(tst)
    for name in jstate.MemState._fields:
        want = getattr(host.mem, name)
        if want is None:
            assert getattr(tst.mem, name) is None, f"{label}: {name}"
            continue
        got = getattr(port.mem, name)
        pairs = (zip((f"{name}.{f}" for f in want._fields), want, got)
                 if name == "tele" else ((name, want, got),))
        for leaf, w, g in pairs:
            assert g.dtype == np.asarray(w).dtype, f"{label}: {leaf} dtype"
            np.testing.assert_array_equal(g, np.asarray(w),
                                          err_msg=f"{label}: leaf {leaf!r}")
    for name in ("core_ptr", "done_cycle"):
        np.testing.assert_array_equal(getattr(port, name),
                                      np.asarray(getattr(host, name)),
                                      err_msg=f"{label}: {name}")


def _looped(pt: tgrid.SweepPoint) -> system.SimResult:
    return ramulator.simulate(
        pt.scheme, workloads.build_trace(pt, device=CPU), pt.n_rows,
        alpha=pt.alpha, r=pt.r, n_data=pt.n_data,
        n_cycles=pt.resolved_cycles(), select_period=pt.select_period,
        wq_hi=pt.wq_hi, wq_lo=pt.wq_lo, queue_depth=pt.queue_depth,
        device=CPU)


def _jax_batch(batch, priors=None):
    """JAX's engine on one batch: its results and final batched state (the
    program ``repro.sweep.run_batch`` compiles)."""
    pts = batch.points
    traced = len({pt.derived_slots()[:2] for pt in pts}) > 1
    jsys = jeng.system_for(pts[0], jgrid.batch_geometry_alloc(pts), traced)
    trace_b = jwork.stack_traces([jwork.build_trace(pt) for pt in pts])
    tn_b = jeng.stack_tunables(pts, jsys.p.queue_depth)
    pri = None if priors is None else jeng._stack_priors(priors, len(pts))
    st = jeng._scan_batch(jsys, jeng._batched_init(jsys, tn_b, pri),
                          trace_b, tn_b, pts[0].resolved_cycles())
    return jeng.summarize_batch(st), st


# ----------------------------------------------------------------- geometry
ALLOC = [
    (0.25, {}), (0.25, {"n_slots_alloc": 3}),
    (0.25, {"region_size_alloc": 16}), (0.25, {"n_regions_alloc": 12}),
    (0.25, {"region_size_alloc": 16, "n_regions_alloc": 10,
            "n_slots_alloc": 4, "traced_geometry": True}),
    (1.0, {"n_slots_alloc": 10, "traced_geometry": True}),
    # each alloc below the derived geometry, and a full-coverage change
    (0.25, {"n_slots_alloc": 1}), (0.25, {"region_size_alloc": 4}),
    (0.25, {"n_regions_alloc": 4}), (0.25, {"n_slots_alloc": 8}),
    (1.0, {"n_slots_alloc": 6}),
]


@pytest.mark.parametrize("alpha,kw", ALLOC, ids=str)
def test_make_params_alloc_matches_jax(alpha, kw):
    """``make_params`` with each padded-allocation argument equals JAX's
    field for field, and raises JAX's message where JAX raises."""
    def build(mod, tables):
        try:
            return mod.make_params(tables, 64, alpha, 0.125, **kw), None
        except ValueError as e:
            return None, str(e)

    jp, jerr = build(jstate, jcodes.get_tables("scheme_i"))
    tp, terr = build(state, codes.get_tables("scheme_i"))
    assert terr == jerr
    if jp is not None:
        assert tuple(tp) == tuple(jp) and tp._fields == jp._fields
    assert state.derive_geometry(64, alpha, 0.125) == \
        jstate.derive_geometry(64, alpha, 0.125)


INIT_SETS = {
    # name: (points, region priors)
    "full_traced": (jgrid.grid(JBASE, alpha=(1.0,), r=(0.125, 0.25),
                               seed=(0, 1)), None),
    "sub_traced": (jgrid.grid(JBASE, alpha=(0.25, 0.5), r=(0.125, 0.25)),
                   None),
    "priors_traced": (jgrid.grid(JBASE, alpha=(0.5,),
                                 r=(0.125, 0.25, 0.0625)),
                      [[1, 4], [2], None]),
    "priors_alpha_axis": (jgrid.grid(JBASE, alpha=(0.25, 0.5), seed=(0, 1)),
                          [[3, 5], [-1, 6, 2], [9, 1], []]),
}


@pytest.mark.parametrize("name", sorted(INIT_SETS))
def test_init_batch_matches_jax(name):
    """Each point's initial state inside a padded allocation (its own
    identity map, slot budget and valid parity rows), with and without
    (B, K) region priors, equals JAX's ``vmap(sys.init)``; so do the
    batch's system and stacked tunables."""
    jpts, priors = INIT_SETS[name]
    tpts = [_tpt(p) for p in jpts]
    traced = len({pt.derived_slots()[:2] for pt in jpts}) > 1
    assert traced == name.endswith("traced")
    alloc = jgrid.batch_geometry_alloc(jpts)
    jsys = jeng.system_for(jpts[0], alloc, traced)
    tsys = engine.system_for(tpts[0], alloc, traced, device=CPU)
    assert tuple(tsys.p) == tuple(jsys.p)
    jtn = jeng.stack_tunables(jpts, jsys.p.queue_depth)
    ttn = engine.stack_tunables(tpts, tsys.p.queue_depth, CPU)
    assert torch.equal(torch.stack(list(ttn)),
                       torch.from_numpy(np.stack(list(map(np.asarray, jtn)))))
    n = len(jpts)
    jpri = None if priors is None else jeng._stack_priors(priors, n)
    tpri = None if priors is None else engine._stack_priors(priors, n)
    assert_states_equal(jeng._batched_init(jsys, jtn, jpri),
                        tsys.init_batch(ttn, tpri), name)


# ------------------------------------------------------------------ engine
CASES = {
    # case: (points, batches)
    **{f"{s}_trace_seed": (jgrid.grid(JBASE.replace(scheme=s),
                                      trace=("banded", "uniform"),
                                      seed=(0, 1)), 1)
       for s in ("uncoded", "scheme_i", "scheme_ii", "scheme_iii")},
    "tunable_axis": (jgrid.grid(JBASE, select_period=(4, 16), wq_hi=(4, 8)),
                     1),
    "mixed_shapes": (jgrid.grid(JBASE, alpha=(0.25, 1.0), r=(0.125, 0.25)),
                     2),
    "alpha_axis": (jgrid.grid(JBASE, alpha=(0.125, 0.25, 0.5),
                              seed=(0, 1)), 1),
    "r_axis": (jgrid.grid(JBASE, alpha=(0.25, 0.5), r=(0.125, 0.25)), 1),
    "full_coverage_r_axis": (jgrid.grid(JBASE, alpha=(1.0,),
                                        r=(0.125, 0.25), seed=(0, 1)), 1),
    "alpha_below_r": (jgrid.grid(JBASE, alpha=(0.05, 0.25, 0.5)), 1),
    "priors": (jgrid.grid(JBASE, alpha=(0.25, 0.5), seed=(3,),
                          select_period=(4, 32)), 1),
}
PRIORS = [[5, 2], [1, 6, 3], None, [7]]


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_points_matches_jax_and_looped(case):
    """Every point of the batch equals JAX's engine (SimResult and every
    final state leaf of the batched state) and the port's looped
    ``simulate`` (mirrors ``tests/test_sweep.py:34-116``): per scheme, a
    tunable axis, mixed shapes in point order, an α axis and an r axis as
    one batch each, the full-coverage r axis, α below r, region priors."""
    jpts, n_batches = CASES[case]
    tpts = [_tpt(p) for p in jpts]
    priors = PRIORS if case == "priors" else None
    jbatches, tbatches = jgrid.partition(jpts), tgrid.partition(tpts)
    assert len(tbatches) == len(jbatches) == n_batches
    assert [b.indices for b in tbatches] == [b.indices for b in jbatches]
    for jb, tb in zip(jbatches, tbatches):
        bpri = None if priors is None else [priors[i] for i in tb.indices]
        want, jst = _jax_batch(jb, bpri)
        got, tst = engine.run_batch(tb, region_priors=bpri, device=CPU,
                                    return_state=True)
        assert got == want, case
        assert_states_equal(jst, tst, f"{case} batch {tb.indices}")
    res = engine.run_points(tpts, region_priors=priors, device=CPU)
    assert res == jeng.run_points(jpts, region_priors=priors)
    if priors is None:
        for pt, r in zip(tpts, res):
            assert r == _looped(pt), pt
    if case == "alpha_below_r":          # 0 slots: an uncoded memory
        tiny = res[0]
        assert tpts[0].derived_slots()[2] == 0 and tiny.completed
        assert (tiny.degraded_reads, tiny.parked_writes, tiny.switches) == (
            0, 0, 0)
    if case in ("scheme_i_trace_seed", "alpha_axis", "r_axis", "priors"):
        assert sum(r.switches for r in res) > 0


def test_kernel_launches_shared_across_the_batch(monkeypatch):
    """A batched cycle calls each kernel wrapper at most once, whatever B
    is: one ``gather_plan`` for every point's reads, one
    ``encode_regions`` for every region encode completing that cycle
    (also on cycles where some points read and others write)."""
    mixed = []
    do_writes = system.CodedMemorySystem._do_writes

    def spy(self, m, rs_a, active=None):
        mixed.append(active is not None)
        return do_writes(self, m, rs_a, active)

    monkeypatch.setattr(system.CodedMemorySystem, "_do_writes", spy)
    calls = {}
    for n_seeds in (1, 3, 8):
        pts = [_tpt(p) for p in jgrid.grid(JBASE,
                                          seed=range(n_seeds))]
        per_cycle = []

        def hook(before, after, out, c=[g_ops.calls, enc_ops.calls]):
            now = [g_ops.calls, enc_ops.calls]
            per_cycle.append((now[0] - c[0], now[1] - c[1]))
            c[:] = now

        res = engine.run_batch(tgrid.partition(pts)[0], device=CPU,
                               on_cycle=hook)
        assert max(g for g, _ in per_cycle) == 1
        assert max(e for _, e in per_cycle) == 1
        enc = sum(e for _, e in per_cycle)
        switches = sum(r.switches for r in res)
        assert enc <= switches and switches > 0
        calls[n_seeds] = (enc, switches)
    assert calls[8][0] < calls[8][1]      # encodes of several points shared
    assert any(mixed)                     # both branches in one cycle


# -------------------------------------------------------- batched wrappers
@pytest.mark.parametrize("scheme", ["scheme_i", "scheme_iii", "uncoded"])
def test_batched_plan_columns_and_gather_equal_per_point(scheme):
    """``plan_columns`` of B plans offsets each point's bank, parity and
    sibling ids, and ``gather_decode`` on (B, ...) banks returns what each
    point's own call returns; ``encode_parities`` on (B, n_data, L, W)
    banks equals each point's encode."""
    rng = np.random.default_rng(5)
    t = codes.get_tables(scheme)
    p = state.make_params(t, n_rows=16, alpha=0.5, r=0.25)
    tab = ctl.jtables(t)
    B, n, rows = 3, 24, 16
    npr = p.n_slots * p.region_size

    def r(hi, shape):
        return torch.from_numpy(rng.integers(0, hi, shape).astype(np.int32))

    args = [r(p.n_data, (B, n)), r(rows, (B, n)), r(50, (B, n)),
            torch.from_numpy(rng.random((B, n)) < 0.8),
            torch.from_numpy(np.append(rng.random((B, p.n_ports)) < 0.3,
                                       np.zeros((B, 1), bool), 1)),
            r(len(t.scheme.members) + 1, (B, p.n_data, rows))
            * torch.from_numpy((rng.random((B, p.n_data, rows))
                                < 0.2).astype(np.int32)),
            torch.from_numpy(rng.random((B, p.n_parities, npr)) < 0.7),
            r(p.n_slots, (B, p.n_regions))]
    plan = ctl.build_read_patterns(p, tab, *args)
    cb, ci, _, _, _, fresh, _, rslot = args
    cols = g_ops.plan_columns(tab, plan, cb, ci, rslot, p.region_size, fresh)
    banks = torch.from_numpy(rng.integers(-2**31, 2**31, (B, p.n_data, rows,
                                                          1), dtype=np.int32))
    pars = torch.from_numpy(rng.integers(-2**31, 2**31, (B, p.n_parities, npr,
                                                         1), dtype=np.int32))
    got = g_ops.gather_decode(banks, pars, cols).view(B, n)
    for b in range(B):
        one = ctl.build_read_pattern(p, tab, *(a[b] for a in args))
        for name in ctl.ReadPlan._fields:
            assert torch.equal(getattr(plan, name)[b], getattr(one, name))
        c1 = g_ops.plan_columns(tab, one, cb[b], ci[b], rslot[b],
                                p.region_size, fresh[b])
        assert torch.equal(got[b], g_ops.gather_decode(banks[b], pars[b],
                                                       c1)[:, 0])
    enc = enc_ops.encode_parities(banks, tab.par_members)
    for b in range(B):
        assert torch.equal(enc[b], encode_parities_plain(
            banks[b], enc_ops.member_table(tab.par_members, CPU)))
    assert torch.equal(got.view(-1, 1), gather_decode_plain(
        banks.flatten(0, 1), pars.flatten(0, 1), *cols))


# ------------------------------------------------------------ grid, traces
PARTITION_SETS = {
    "seeds_plus_rows": jgrid.grid(JBASE, seed=range(4))
    + [JBASE.replace(n_rows=32)],
    "alpha_r_grid": jgrid.grid(JBASE, alpha=(0.1, 0.25, 1.0),
                               r=(0.05, 0.125)),
    "schemes_tunables": jgrid.grid(JBASE, scheme=("uncoded", "scheme_i"),
                                   wq_hi=(4, 8), n_cycles=(None, 50)),
}


@pytest.mark.parametrize("name", sorted(PARTITION_SETS))
def test_partition_and_signature_match_jax(name):
    jpts = PARTITION_SETS[name]
    tpts = [_tpt(p) for p in jpts]
    assert [tgrid.static_signature(p) for p in tpts] == \
        [jgrid.static_signature(p) for p in jpts]
    for jb, tb in zip(jgrid.partition(jpts), tgrid.partition(tpts)):
        assert (tb.signature, tb.indices) == (jb.signature, jb.indices)
        assert tgrid.batch_geometry_alloc(tb.points) == \
            jgrid.batch_geometry_alloc(jb.points)
    assert len(tgrid.partition(tpts)) == len(jgrid.partition(jpts))
    assert tgrid.grid(_tpt(JBASE), alpha=(0.1, 0.5), seed=range(3)) == \
        [_tpt(p) for p in jgrid.grid(JBASE, alpha=(0.1, 0.5), seed=range(3))]
    with pytest.raises(ValueError, match="unknown SweepPoint fields"):
        tgrid.grid(_tpt(JBASE), no_such_field=(1,))


@pytest.mark.parametrize("name", ["banded", "split", "ramp", "uniform",
                                  "zipf"])
def test_build_trace_matches_jax(name):
    jpt = JBASE.replace(trace=name, seed=4, write_frac=0.4, issue_prob=0.8)
    want = jwork.build_trace(jpt)
    got = workloads.build_trace(_tpt(jpt), device=CPU)
    for a, b in zip(got, _jtrace_to_port(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_stack_traces_rejects_mixed_shapes():
    pts = [JBASE, JBASE.replace(length=14)]
    with pytest.raises(ValueError) as je:
        jwork.stack_traces([jwork.build_trace(p) for p in pts])
    with pytest.raises(ValueError) as te:
        workloads.stack_traces([workloads.build_trace(_tpt(p), device=CPU)
                                for p in pts])
    assert str(te.value) == str(je.value)
    stacked = workloads.stack_traces([workloads.build_trace(
        _tpt(JBASE.replace(seed=s)), device=CPU) for s in range(3)])
    assert tuple(stacked.bank.shape) == (3, 3, 12)


def _error(fn):
    try:
        fn()
    except (KeyError, FileNotFoundError, ValueError) as e:
        return type(e), str(e)
    raise AssertionError("no error raised")


def test_build_trace_errors_match_jax(tmp_path):
    """Each of ``build_trace``'s errors names the point as JAX's does:
    an unknown generator, a missing file, a file that outgrows the point,
    a file of another shape, and one mapped for another geometry."""
    big = tmp_path / "big.trace"
    big.write_text("".join(f"{i} R\n" for i in range(40)))
    npz = save_npz(str(tmp_path / "wide.npz"),
                   rand_trace(np.random.default_rng(0), 2, 6, 8, 512))
    base = JBASE.replace(suite="s", label="x")
    bad = [
        base.replace(trace="no_such_generator"),
        base.replace(trace="file:/does/not/exist.npz"),
        base.replace(trace=f"file:{big}", length=2, n_cores=2),
        base.replace(trace=f"file:{os.path.join(DATA, 'tiny_trace.npz')}"),
        base.replace(trace=f"file:{npz}", n_cores=2, length=6),
    ]
    for pt in bad:
        want = _error(lambda: jwork.build_trace(pt, index=7))
        got = _error(lambda: workloads.build_trace(_tpt(pt), index=7,
                                                   device=CPU))
        assert got == want, pt.trace
    with pytest.raises(FileNotFoundError, match=r"\[1\]"):
        engine.run_points([_tpt(JBASE), _tpt(bad[1])], device=CPU)


def test_engine_rejects_what_is_not_ported():
    """Every point kind runs: a faulted point (its fault leaf compared with
    JAX in tests/test_torch_faults.py) and a telemetry-on one, whose
    snapshot ``collect_telemetry`` returns (None for a telemetry-off
    point; the planes compared with JAX in tests/test_torch_obs.py);
    misaligned traces raise."""
    pt = _tpt(JBASE)
    faulted = pt.replace(faults=(("bank", 0, 4),))
    assert engine.run_points([faulted], device=CPU)[0].dead_bank_cycles > 0
    on = engine.run_points([pt.replace(telemetry=True)], device=CPU)
    assert on == engine.run_points([pt], device=CPU)
    res, snaps = engine.run_points([pt, pt.replace(telemetry=True)],
                                   device=CPU, collect_telemetry=True)
    assert snaps[0] is None and res == on * 2
    assert snaps[1].served_reads() == res[1].served_reads
    with pytest.raises(ValueError, match="align"):
        engine.run_points([pt], traces=[], device=CPU)


def test_shard_is_one_cards_path(monkeypatch):
    """``shard`` is JAX's positional third argument, default True; on one
    device it is the unsharded run. The sweep mesh is every visible card
    for the card and the CPU alone for the CPU (the sharded runs are
    tests/test_torch_sweep_shard.py's)."""
    pts = [_tpt(JBASE.replace(seed=s)) for s in (0, 1)]
    assert (engine.run_points(pts, None, True, device=CPU)
            == engine.run_points(pts, None, False, device=CPU)
            == engine.run_points(pts, device=CPU))
    cuda = torch.device("cuda")
    assert engine.shard_devices(cuda, False) == [cuda]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.make_sweep_mesh(device=cuda) == [torch.device("cuda", 0),
                                                 torch.device("cuda", 1)]
    assert engine.shard_devices(cuda, True) == [torch.device("cuda", 0),
                                                torch.device("cuda", 1)]
    assert mesh.make_sweep_mesh(1, device=cuda) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="visible"):
        mesh.make_sweep_mesh(3, device=cuda)
    assert mesh.make_sweep_mesh(device=CPU) == [torch.device(CPU)]
    assert engine.shard_devices(torch.device(CPU), True) == [
        torch.device(CPU)]
