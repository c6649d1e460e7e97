"""Bank faults in the port (``repro_torch.faults`` through the batched
core) on the CPU against the JAX package and its NumPy oracle, bit for
bit: the plan grammar and its errors, the erasure-tolerance matrix, the
flag-off identity, the seeded fault storms of ``tests/test_faults.py``
leaf for leaf, online rebuild and quiescence, the chunk exits, batches of
mixed plans, and streamed replay of faulted points with kill-and-resume.

The JAX systems run with ``make_params(faults=True)``, and the storms and
the mixed-plan batches with telemetry off and on, as JAX's storms run
(their planes, class 4 and ``dead_cycles`` included, equal to JAX's and
to the oracle's); inputs are made with numpy from a seed and handed to
both sides."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import oracle_twin, rand_trace
from test_faults import _storm_plan
from test_torch_obs import assert_planes_match_oracle, assert_snapshots_equal
from test_torch_sim import _jtrace_to_port, assert_states_equal

import repro.faults as jfaults
from repro.core import codes as jcodes
from repro.core import state as jstate
from repro.core import system as jsys
from repro.sweep import SweepPoint as JPoint
from repro.sweep import run_points as jrun_points
from repro.sweep.workloads import build_trace as jbuild_trace
from repro.traces.stream import stream_replay_points as jstream_points
from repro_torch import convert
from repro_torch import faults
from repro_torch.core import codes, state, system
from repro_torch.faults import FaultPlan, plan_from_spec
from repro_torch.obs.planes import snapshot as tobs_snapshot
from repro_torch.sweep import SweepPoint, partition, run_points
from repro_torch.sweep.workloads import build_trace
from repro_torch.traces import stream_replay_points, strip_windows

CPU = "cpu"
FIVE = ["scheme_i", "scheme_ii", "scheme_iii", "replication_2", "uncoded"]


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    """JAX compiles this file's programs at XLA's backend optimization
    level 0 (``jax_disable_most_optimizations``; the simulator is integer
    arithmetic, so its results do not depend on it) and torch runs on one
    intra-op thread: the optimizing compiles took most of the file's
    worker time, and a worker died in one. The JAX systems are built once
    a configuration (``_systems``). Both settings are restored after the
    module's tests."""
    saved = (jax.config.read("jax_disable_most_optimizations"),
             torch.get_num_threads())
    jax.config.update("jax_disable_most_optimizations", True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_disable_most_optimizations", saved[0])
    torch.set_num_threads(saved[1])


def _error(fn):
    try:
        fn()
    except Exception as e:                      # noqa: BLE001
        return type(e).__name__, str(e)
    return None


@functools.lru_cache(maxsize=None)
def _systems(scheme="scheme_i", n_rows=32, alpha=1.0, r=0.25, n_cores=3,
             faults_on=True, recode_cap=8, telemetry=False):
    """A JAX system and the port's twin (select period 16), built once."""
    jt = jcodes.get_tables(scheme)
    jp = jstate.make_params(jt, n_rows=n_rows, alpha=alpha, r=r,
                            recode_cap=recode_cap, faults=faults_on,
                            telemetry=telemetry)
    js = jsys.CodedMemorySystem(jt, jp, n_cores=n_cores,
                                tunables=jstate.make_tunables(
                                    select_period=16))
    tt = codes.get_tables(scheme)
    tp = state.make_params(tt, n_rows=n_rows, alpha=alpha, r=r,
                           recode_cap=recode_cap, faults=faults_on,
                           telemetry=telemetry)
    ts = system.CodedMemorySystem(tt, tp, n_cores=n_cores, device=CPU,
                                  tunables=state.make_tunables(
                                      select_period=16))
    return js, ts


def assert_fault_states_equal(jst, tst, label=""):
    """Every leaf of a JAX SimState equals the port's, the fault leaf's
    included (``dead_cycles`` through ``convert``'s uint32)."""
    assert_states_equal(jst._replace(mem=jst.mem._replace(fault=None)),
                        tst._replace(mem=tst.mem._replace(fault=None)),
                        label)
    want = jax.device_get(jst.mem.fault)
    got = convert.sim_state_to_numpy(tst).mem.fault
    assert (want is None) == (got is None), f"{label}: fault leaf"
    if want is None:
        return
    for name, a, b in zip(want._fields, want, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype, f"{label}: fault.{name} dtype"
        np.testing.assert_array_equal(b, a,
                                      err_msg=f"{label}: fault.{name}")


def _plans(spec, jsys_, tsys_):
    return (jfaults.plan_from_spec(spec, jsys_.p.n_data,
                                   jsys_.tables.n_ports),
            plan_from_spec(spec, tsys_.p.n_data, tsys_.tables.n_ports))


# ------------------------------------------------------------ plan grammar
def test_plan_grammar_matches_jax():
    spec = (("bank", 2, 5, 60), ("bank", 0, 3), ("stutter", 1, 7, 3),
            ("stutter", 9, 5))
    jp = jfaults.plan_from_spec(spec, n_data=8, n_ports=20)
    tp = plan_from_spec(spec, n_data=8, n_ports=20)
    assert (tp.bank_faults, tp.stutters) == (jp.bank_faults, jp.stutters)
    for a, b in zip(tp.schedule_arrays(), jp.schedule_arrays()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tp.state(CPU), jp.state()):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy().astype(b.dtype), b)
    assert faults.NEVER == jfaults.NEVER
    assert plan_from_spec((), 8, 20) is None
    assert plan_from_spec(None, 8, 20) is None
    assert faults.__all__ == jfaults.__all__


def test_plan_validation_errors_match_jax():
    cases = [
        lambda m: m.FaultPlan(8, 20, bank_faults=((8, 0, -1),)),
        lambda m: m.FaultPlan(8, 20, bank_faults=((1, -2, -1),)),
        lambda m: m.FaultPlan(8, 20, bank_faults=((1, 10, 5),)),
        lambda m: m.FaultPlan(8, 20, bank_faults=((1, 0, -1), (1, 4, -1))),
        lambda m: m.FaultPlan(8, 20, stutters=((20, 4, 0),)),
        lambda m: m.FaultPlan(8, 20, stutters=((0, 4, 4),)),
        lambda m: m.FaultPlan(8, 20, stutters=((0, 0, 0),)),
        lambda m: m.plan_from_spec((("flood", 1, 2),), 8, 20),
    ]
    for case in cases:
        want = _error(lambda: case(jfaults))
        assert want is not None
        assert _error(lambda: case(faults)) == want


def test_init_plan_errors_match_jax():
    """A plan on a faults-off system and a plan of another geometry raise
    JAX's ValueErrors, from ``init_state`` and ``CodedMemorySystem.init``."""
    for faults_on, plan_geom in ((False, (8, 20)), (True, (8, 19))):
        js, ts = _systems(faults_on=faults_on)
        jp = jfaults.FaultPlan(*plan_geom, bank_faults=((0, 0, -1),))
        tp = FaultPlan(*plan_geom, bank_faults=((0, 0, -1),))
        want = _error(lambda: js.init(fault_plan=jp))
        assert want is not None and want[0] == "ValueError"
        assert _error(lambda: ts.init(fault_plan=tp)) == want
        assert _error(lambda: state.init_state(ts.p, fault_plan=tp)) == want


# -------------------------------------------------------- erasure tolerance
@pytest.mark.parametrize("scheme", FIVE)
def test_erasure_tolerance_matches_jax(scheme):
    j = jcodes.get_tables(scheme).scheme
    t = codes.get_tables(scheme).scheme
    assert t.erasure_tolerance(2) == j.erasure_tolerance(2)
    assert t.erasure_tolerance(1) == j.erasure_tolerance(1)
    assert t.serving_recoverable(()) and j.serving_recoverable(())
    want = _error(lambda: j.serving_recoverable((t.n_data,)))
    assert _error(lambda: t.serving_recoverable((t.n_data,))) == want


# -------------------------------------------------------- flag-off identity
def test_faults_off_leaf_is_none_and_quiet_faults_are_inert():
    """Faults off: the ``fault`` leaf is None. Faults on with no plan: the
    no-fault schedule (JAX's leaf, leaf for leaf), and a run equal to the
    flag-off run in every result field and every other leaf."""
    rng = np.random.default_rng(21)
    trace = _jtrace_to_port(rand_trace(rng, 3, 12, 8, 32))
    n = jsys.drain_bound(3, 12)
    _, off = _systems(faults_on=False)
    js, on = _systems(faults_on=True)
    assert off.init().mem.fault is None and not off.p.faults
    assert_fault_states_equal(js.init(), on.init(), "init")
    st_off, _ = off._run(off.init(), trace, n)
    st_on, _ = on._run(on.init(), trace, n)
    assert_states_equal(jsys.SimState(
        *convert.sim_state_to_numpy(st_off)), st_on._replace(
            mem=st_on.mem._replace(fault=None)), "off vs on")
    res_on = on.summarize(st_on)
    assert off.summarize(st_off) == res_on
    assert (res_on.unserved_reads, res_on.lost_writes,
            res_on.fault_degraded_reads, res_on.dead_bank_cycles) == (
                0, 0, 0, 0)


def test_sweep_partitions_on_the_flag_only():
    """``faults=()`` points batch as before; a faulted point is another
    batch, and points with different plans share one."""
    base = SweepPoint(scheme="scheme_i", alpha=1.0, r=0.25, n_rows=32,
                      n_cores=3, n_banks=8, length=10, select_period=16,
                      recode_cap=8)
    pts = [base.replace(seed=s) for s in range(3)]
    assert len(partition(pts)) == 1
    faulted = [base.replace(faults=(("bank", 0, 0),)),
               base.replace(faults=(("bank", 3, 8, 40),), seed=1)]
    assert [b.indices for b in partition(pts + faulted)] == [[0, 1, 2],
                                                             [3, 4]]


# ------------------------------------------------------------ fault storms
STORMS = [(scheme, alpha, r, seed)
          for scheme, alpha, r in (("scheme_i", 1.0, 0.25),
                                   ("scheme_iii", 0.25, 0.125))
          for seed in (101, 102)]


@pytest.mark.parametrize("scheme,alpha,r,seed,telemetry", [
    pytest.param(*c, tele, id="-".join(map(str, c))
                 + ("-telemetry" if tele else ""))
    for c in STORMS for tele in (False, True)])
def test_fault_storm_matches_jax_and_oracle(scheme, alpha, r, seed,
                                            telemetry):
    """JAX's seeded storm (``_storm_plan``) cycle by cycle on both sides:
    every state leaf, the fault leaf's included, equal at cycles 20, 60
    and 120, and the result equal to JAX's and to the oracle's; with
    telemetry on (as JAX's storms run) the planes too, against the
    oracle's, with ``dead_cycles`` equal to the fault leaf's."""
    js, ts = _systems(scheme, alpha=alpha, r=r, telemetry=telemetry)
    om = oracle_twin(js)
    rng = np.random.default_rng(seed)
    spec = _storm_plan(rng, js)
    jplan, tplan = _plans(spec, js, ts)
    trace = rand_trace(rng, js.n_cores, 12, js.p.n_data, js.p.n_rows,
                       write_frac=0.45)
    ttr = _jtrace_to_port(trace)
    tr_np = tuple(np.asarray(x) for x in trace)
    jst = js.init(fault_plan=jplan)
    tst = ts.init(fault_plan=tplan)
    ost = om.init_state(fault_plan=jplan)
    label = f"{scheme} seed={seed} spec={spec}"
    for cyc in range(120):
        jst, _ = js.cycle_fn(jst, trace)
        tst, _ = ts.cycle_fn(tst, ttr)
        om.cycle(ost, tr_np)
        if cyc in (20, 60):
            assert_fault_states_equal(jst, tst, f"{label} @{cyc}")
    assert_fault_states_equal(jst, tst, label)
    res = ts.summarize(tst)
    assert res == js.summarize(jst) == om.result(ost), label
    if telemetry:
        assert_planes_match_oracle(tst.mem.tele, ost, label)
        assert torch.equal(tst.mem.tele.dead_cycles,
                           tst.mem.fault.dead_cycles)
        snap = tobs_snapshot(tst)
        assert snap.fault_degraded_reads() == res.fault_degraded_reads
        assert snap.degraded_reads() == res.degraded_reads


@pytest.mark.parametrize("scheme,alpha,r", [("scheme_i", 0.25, 0.125),
                                            ("scheme_ii", 1.0, 0.25),
                                            ("uncoded", 1.0, 0.25)])
def test_early_fault_storm_under_load_matches_jax(scheme, alpha, r):
    """Failures from cycle 0 to 9 on 3 cores x 48 requests: the storms of
    the seeded test with their fail times quartered, so the dead and
    rebuilding banks meet a loaded system (drops, fault-degraded reads,
    sticky parks, rebuild pushes), every leaf equal to JAX's at the end
    of 200 cycles."""
    js, ts = _systems(scheme, alpha=alpha, r=r)
    rng = np.random.default_rng(1)
    spec = tuple(e if e[0] != "bank" else
                 ("bank", e[1], e[2] // 4, *e[3:]) for e in
                 _storm_plan(rng, js))
    jplan, tplan = _plans(spec, js, ts)
    trace = rand_trace(rng, js.n_cores, 48, js.p.n_data, js.p.n_rows,
                       write_frac=0.45)
    jst, _ = js._run(js.init(fault_plan=jplan), trace, 200)
    tst, _ = ts._run(ts.init(fault_plan=tplan), _jtrace_to_port(trace),
                     200)
    assert_fault_states_equal(jst, tst, f"{scheme} {spec}")
    res = ts.summarize(tst)
    assert res == js.summarize(jst)
    assert res.dead_bank_cycles > 0


# ------------------------------------------------------ rebuild, quiescence
def test_online_rebuild_relatches_bank_as_jax():
    """A failed bank that recovers is rebuilt through the recode ring and
    rejoins (``rebuilt`` latches, dead-cycle accrual stops, no read lost),
    with every leaf equal to JAX's after 400 cycles."""
    js, ts = _systems("scheme_i")
    jplan, tplan = _plans((("bank", 2, 5, 30),), js, ts)
    rng = np.random.default_rng(5)
    trace = rand_trace(rng, ts.n_cores, 12, ts.p.n_data, ts.p.n_rows)
    jst, _ = js._run(js.init(fault_plan=jplan), trace, 400)
    tst, _ = ts._run(ts.init(fault_plan=tplan), _jtrace_to_port(trace),
                     400)
    assert_fault_states_equal(jst, tst, "rebuild")
    assert bool(tst.mem.fault.rebuilt[2])
    res = ts.summarize(tst)
    assert res.unserved_reads == 0 and res.lost_writes == 0
    assert 0 < res.dead_bank_cycles < 400


def test_rebuild_sweep_stalls_on_a_full_ring_as_jax():
    """A rebuild whose pushes find the recode ring full (capacity 4,
    write-heavy traffic) stalls its cursor where JAX's sequential pushes
    do: every leaf, the ring and cursor included, equal cycle by cycle
    through the sweep."""
    js, ts = _systems("scheme_i", recode_cap=4)
    jplan, tplan = _plans((("bank", 1, 0, 6), ("bank", 6, 2, 9)), js, ts)
    rng = np.random.default_rng(9)
    trace = rand_trace(rng, ts.n_cores, 40, ts.p.n_data, ts.p.n_rows,
                       write_frac=0.8)
    ttr = _jtrace_to_port(trace)
    jst, tst = js.init(fault_plan=jplan), ts.init(fault_plan=tplan)
    stalls = 0
    for cyc in range(150):
        ptr0 = int(tst.mem.fault.rebuild_ptr)
        jst, _ = js.cycle_fn(jst, trace)
        tst, _ = ts.cycle_fn(tst, ttr)
        moved = int(tst.mem.fault.rebuild_ptr) - ptr0
        stalls += int(0 <= moved < ts.p.recode_budget
                      and int(tst.mem.fault.rebuild_ptr) < 8 * 32
                      and bool(tst.mem.rc_valid.all()))
        assert_fault_states_equal(jst, tst, f"@{cyc}")
    assert stalls > 0


def _chunk(js, ts, spec, length=12, seed=6):
    """A fresh state of each side and a seeded trace staged whole
    (every core's stream ends inside the chunk)."""
    jplan, tplan = _plans(spec, js, ts)
    rng = np.random.default_rng(seed)
    trace = rand_trace(rng, ts.n_cores, length, ts.p.n_data, ts.p.n_rows)
    se = np.full((ts.n_cores,), length, np.int32)
    return (js.init(fault_plan=jplan), ts.init(fault_plan=tplan), trace,
            _jtrace_to_port(trace), se)


@pytest.mark.parametrize("spec", [(("bank", 0, 0),), (("bank", 2, 5, 30),),
                                  (("bank", 3, 60),)])
def test_run_chunk_stops_at_jax_cycle(spec):
    """``run_chunk`` leaves its loop where JAX's does, on the fault clause
    of ``quiescent`` too: a permanent failure still quiesces, a scheduled
    recovery runs until its rebuild latches, a pending failure keeps the
    point running until it fails. Every leaf equal; ``run_chunk_batch``
    over the three plans gives each one's result."""
    js, ts = _systems("scheme_i")
    jst, tst, trace, ttr, se = _chunk(js, ts, spec)
    bound = jsys.drain_bound(ts.n_cores, 12) * 4
    jst = js.run_chunk(jst, trace, jnp.asarray(se), bound)
    tst = ts.run_chunk(tst, ttr, se, bound)
    assert_fault_states_equal(jst, tst, str(spec))
    assert bool(system.quiescent(tst)) and int(tst.mem.cycle) < bound
    res = ts.summarize(tst)
    assert res.completed and res.unserved_reads == 0
    if spec[0][2] == 60:               # fails after the drain: no dead cycle
        assert int(tst.mem.cycle) == 60 and res.dead_bank_cycles == 0
    if len(spec[0]) > 3:
        assert bool(tst.mem.fault.rebuilt[2])


def _stack(trees):
    """One point's states (nested NamedTuples of tensors) as a batch."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return type(first)(*(_stack(list(xs)) for xs in zip(*trees)))


def test_run_chunk_batch_of_mixed_plans():
    """``run_chunk_batch`` over a dead bank, a rebuild and a late failure
    gives each point's own ``run_chunk`` result and stops once all three
    are quiescent."""
    specs = [(("bank", 0, 0),), (("bank", 2, 5, 30),), (("bank", 3, 60),)]
    js, ts = _systems("scheme_i")
    want, states = [], []
    for spec in specs:
        _, tst, _, ttr, se = _chunk(js, ts, spec)
        want.append(ts.summarize(ts.run_chunk(tst, ttr, se, 400)))
        states.append(tst)
    st_b = _stack(states)
    tr_b = system.Trace(*(x[None].expand(3, *x.shape) for x in ttr))
    se_b = torch.from_numpy(np.stack([se] * 3))
    out = ts.run_chunk_batch(st_b, tr_b, se_b, 400,
                             state.batch_tunables([ts.tunables] * 3, CPU))
    assert system.summarize_batch(out) == want
    assert bool(system.quiescent(out).all())


# ---------------------------------------------------------- the point axis
BATCH_SPECS = [(("bank", 0, 0),), (("bank", 3, 8, 40),),
               (("bank", 1, 2), ("stutter", 2, 5, 1))]


@pytest.mark.parametrize("kw,telemetry", [
    pytest.param(kw, tele, id=f"kw{k}" + ("-telemetry" if tele else ""))
    for k, kw in enumerate([
        dict(scheme="scheme_i", alpha=1.0, r=0.25),
        dict(scheme="scheme_iii", alpha=0.5)])   # traced geometry: r axis
    for tele in (False, True)])
def test_batch_of_mixed_plans_equals_jax_and_looped(kw, telemetry):
    """Faulted points with different plans run as one batch; each point
    equals JAX's ``run_points`` in every field, and the port's looped
    faulted ``run`` of it; with telemetry on each point's snapshot equals
    JAX's plane for plane (class 4 and the dead cycles included)."""
    common = dict(n_rows=32, n_cores=3, n_banks=8, length=10,
                  select_period=16, recode_cap=8, telemetry=telemetry)
    rs = (0.125, 0.25) if "r" not in kw else (kw["r"],)
    coords = [(i, sp, r) for i, sp in enumerate(BATCH_SPECS) for r in rs]
    tpts = [SweepPoint(**common, **kw, r=r, seed=i, faults=sp)
            if "r" not in kw else
            SweepPoint(**common, **kw, seed=i, faults=sp)
            for i, sp, r in coords]
    jpts = [JPoint(**{f: getattr(pt, f) for f in (
        "scheme", "n_rows", "alpha", "r", "n_cores", "n_banks", "length",
        "select_period", "recode_cap", "seed", "faults", "telemetry")})
        for pt in tpts]
    assert len(partition(tpts)) == 1
    if telemetry:
        got, snaps = run_points(tpts, device=CPU, collect_telemetry=True)
        want, jsnaps = jrun_points(jpts, collect_telemetry=True)
        for k, (g, w) in enumerate(zip(snaps, jsnaps)):
            assert_snapshots_equal(g, w, f"point {k}")
        assert sum(s.fault_degraded_reads() for s in snaps) == sum(
            r.fault_degraded_reads for r in got)
        if kw["scheme"] == "scheme_i":          # class 4 is exercised
            assert sum(s.fault_degraded_reads() for s in snaps) > 0
    else:
        got, want = run_points(tpts, device=CPU), jrun_points(jpts)
    assert got == want
    for pt, res in zip(tpts, got):
        t = codes.get_tables(pt.scheme)
        p = state.make_params(t, pt.n_rows, pt.alpha, pt.r, recode_cap=8,
                              faults=True, telemetry=telemetry)
        sys_ = system.CodedMemorySystem(t, p, n_cores=3, device=CPU)
        tn = state.make_tunables(select_period=pt.select_period)
        plan = plan_from_spec(pt.faults, p.n_data, p.n_ports)
        want = sys_.run(build_trace(pt, device=CPU), pt.resolved_cycles(),
                        tn=tn, fault_plan=plan)
        assert res == want, pt.faults
    assert sum(r.fault_degraded_reads + r.unserved_reads for r in got) > 0


def test_stream_replay_points_faulted_matches_jax(tmp_path):
    """A faulted batch streamed at chunk 4 equals JAX's
    ``stream_replay_points`` (windows included) and ``run_points``; a pass
    killed after a checkpoint resumes to the same results (the fault leaf
    is saved and restored)."""
    common = dict(scheme="scheme_i", alpha=0.25, r=0.125, n_rows=32,
                  n_cores=3, n_banks=8, length=10, select_period=16,
                  recode_cap=8)
    tpts = [SweepPoint(**common, seed=i, faults=sp)
            for i, sp in enumerate(BATCH_SPECS)]
    jpts = [JPoint(**common, seed=i, faults=sp)
            for i, sp in enumerate(BATCH_SPECS)]
    jtr = [jbuild_trace(p) for p in jpts]
    ttr = [build_trace(p, device=CPU) for p in tpts]
    want = jstream_points(jpts, jtr, chunk_len=4)
    got = stream_replay_points(tpts, ttr, chunk_len=4, device=CPU)
    assert got == want
    assert [strip_windows(g) for g in got] == run_points(tpts, device=CPU)
    kw = dict(chunk_len=4, device=CPU, checkpoint_dir=str(tmp_path),
              checkpoint_every=2)
    cut = stream_replay_points(tpts, ttr, max_cycles=4, **kw)
    assert cut != got
    assert stream_replay_points(tpts, ttr, resume=True, **kw) == got


def test_convert_carries_the_fault_leaf():
    """A JAX faulted state mid-run converts to the port and back, leaf for
    leaf, and the port runs on from it as JAX does."""
    js, ts = _systems("scheme_i")
    jplan, _ = _plans((("bank", 2, 5, 30), ("stutter", 9, 3, 1)), js, ts)
    rng = np.random.default_rng(3)
    trace = rand_trace(rng, ts.n_cores, 12, 8, 32)
    jst, _ = js._run(js.init(fault_plan=jplan), trace, 20)
    tst = convert.sim_state_from_numpy(jax.device_get(jst), CPU)
    assert tst.mem.fault.dead_cycles.dtype == torch.int64
    assert_fault_states_equal(jst, tst, "converted")
    jst2, _ = js._run(jst, trace, 30)
    tst2, _ = ts._run(tst, _jtrace_to_port(trace), 30)
    assert_fault_states_equal(jst2, tst2, "ran on")
