"""The port's coded-memory simulator (``repro_torch.core`` / ``sim``) on the
CPU against the JAX package and its NumPy oracle, bit for bit: code tables,
geometry, initial state, traces, read/write plans, the recode unit, every
cycle's read datapath, full runs and a state carried across mid-run.

The JAX systems are built once per module (their jit compiles dominate);
inputs are made with numpy from a seed and handed to both sides."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import rand_trace

from repro import oracle
from repro.core import controller as jctl
from repro.core import codes as jcodes
from repro.core import state as jstate
from repro.core import system as jsys
from repro.core.recoding import recode_step as jrecode_step
from repro.sim import ramulator as jram
from repro.sim import trace as jtrace
from repro_torch import convert
from repro_torch.core import codes, controller as ctl, state, system
from repro_torch.core.recoding import recode_step
from repro_torch.kernels.xor_encode import ops as enc_ops
from repro_torch.kernels.xor_gather import ops as g_ops
from repro_torch.sim import ramulator, trace as ttrace

SCHEMES = sorted(jcodes.SCHEMES)
CPU = "cpu"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _jtrace_to_port(tr) -> system.Trace:
    return system.Trace(*(_t(np.asarray(x)) for x in tr))


def assert_states_equal(jst, tst, label=""):
    """Every leaf of a JAX SimState equals the port's (wide counters through
    ``convert.sim_state_to_numpy``'s (lo, hi) pairs, the telemetry planes'
    counters through its uint32), the telemetry leaf's planes included."""
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
    np.testing.assert_array_equal(port.core_ptr, host.core_ptr,
                                  err_msg=f"{label}: core_ptr")
    assert int(port.done_cycle) == int(host.done_cycle), f"{label}: done"


# ------------------------------------------------------------------- tables
@pytest.mark.parametrize("scheme,n_data", [(s, 8) for s in SCHEMES]
                         + [("scheme_iii", 9), ("scheme_i", 12)])
def test_code_tables_match_jax(scheme, n_data):
    j = jcodes.get_tables(scheme, n_data=n_data)
    t = codes.get_tables(scheme, n_data=n_data)
    assert t.scheme.members == j.scheme.members
    assert t.scheme.phys == j.scheme.phys
    assert (t.n_data, t.n_parities, t.n_phys, t.n_ports) == (
        j.n_data, j.n_parities, j.n_phys, j.n_ports)
    for name in ("par_members", "par_phys", "par_port", "opt_parity",
                 "opt_sibs", "opt_n"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    assert t.scheme.rate(0.25) == j.scheme.rate(0.25)
    assert t.scheme.locality() == j.scheme.locality()
    assert (codes.MAX_SIBS, codes.MAX_OPTS) == (jcodes.MAX_SIBS,
                                                jcodes.MAX_OPTS)


# ----------------------------------------------------------------- geometry
GEOMS = [(64, 1.0, 0.125), (64, 0.25, 0.125), (320, 0.25, 0.05),
         (320, 0.04, 0.05), (100, 0.3, 0.07), (32, 0.5, 0.25)]


@pytest.mark.parametrize("n_rows,alpha,r", GEOMS)
def test_params_and_geometry_match_jax(n_rows, alpha, r):
    assert state.derive_geometry(n_rows, alpha, r) == \
        jstate.derive_geometry(n_rows, alpha, r)
    for scheme in ("uncoded", "scheme_i", "scheme_ii"):
        jp = jstate.make_params(jcodes.get_tables(scheme), n_rows=n_rows,
                                alpha=alpha, r=r, queue_depth=6)
        tp = state.make_params(codes.get_tables(scheme), n_rows=n_rows,
                               alpha=alpha, r=r, queue_depth=6)
        assert tuple(tp) == tuple(jp) and tp._fields == jp._fields
    jtn = jstate.make_tunables(queue_depth=6, select_period=0, wq_hi=9,
                               wq_lo=7)
    ttn = state.make_tunables(queue_depth=6, select_period=0, wq_hi=9,
                              wq_lo=7)
    assert tuple(int(x) for x in jtn) == tuple(ttn)


@pytest.mark.parametrize("scheme,alpha", [("scheme_i", 1.0),
                                          ("scheme_i", 0.25),
                                          ("uncoded", 1.0),
                                          ("scheme_iii", 0.5)])
def test_init_state_matches_jax(scheme, alpha):
    jp = jstate.make_params(jcodes.get_tables(scheme), n_rows=64,
                            alpha=alpha, r=0.125, recode_cap=8)
    tp = state.make_params(codes.get_tables(scheme), n_rows=64, alpha=alpha,
                           r=0.125, recode_cap=8)
    jst = jsys.SimState(jstate.init_state(jp), jnp.zeros((4,), jnp.int32),
                        jnp.int32(-1))
    tst = system.SimState(state.init_state(tp), torch.zeros(4,
                                                            dtype=torch.int32),
                          torch.tensor(-1, dtype=torch.int32))
    assert_states_equal(jst, tst, scheme)


def test_flags_not_ported_raise():
    """Every flag is ported: telemetry (tests/test_torch_obs.py) and
    faults (tests/test_torch_faults.py) build their systems, and a fault
    plan given to a faults-off system raises JAX's ValueError."""
    t = codes.get_tables("scheme_i")
    assert state.make_params(t, 64, 0.25, 0.125, telemetry=True).telemetry
    assert state.make_params(t, 64, 0.25, 0.125, faults=True).faults
    assert state.make_params(t, 64, 0.25, 0.125,
                             traced_geometry=True).traced_geometry
    p = state.make_params(t, 64, 0.25, 0.125)
    with pytest.raises(ValueError, match="faults=True"):
        state.init_state(p, fault_plan=object())
    sys_ = system.CodedMemorySystem(t, p, n_cores=2, device=CPU)
    with pytest.raises(ValueError, match="faults=True"):
        sys_.init(fault_plan=object())


# ------------------------------------------------------------------- traces
@pytest.mark.parametrize("name", sorted(jtrace.TRACES))
def test_trace_generators_match_jax(name):
    jspec = jtrace.TraceSpec(n_cores=4, length=40, n_banks=8, n_rows=64,
                             issue_prob=0.9, write_frac=0.3, seed=11)
    tspec = ttrace.TraceSpec(**jspec.__dict__)
    jt = jtrace.TRACES[name](jspec)
    tt = ttrace.TRACES[name](tspec, device=CPU)
    for field, a, b in zip(jsys.Trace._fields, jt, tt):
        assert b.device.type == "cpu"
        assert b.dtype == getattr(torch, np.asarray(a).dtype.name), field
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=field)
    bank, row = ttrace.addr_to_bank_row(np.arange(100), 8, 64)
    jb, jr = jtrace.addr_to_bank_row(np.arange(100), 8, 64)
    assert (bank == jb).all() and (row == jr).all()


def test_entry_points_need_the_card_or_an_explicit_cpu():
    """Without a card, ``device=None`` raises instead of running on the CPU
    (this container has no card)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    spec = ttrace.TraceSpec(n_cores=2, length=4, n_rows=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrace.banded_trace(spec)
    tr = ttrace.banded_trace(spec, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ramulator.simulate("scheme_i", tr, 16, alpha=1.0, r=0.25)
    assert ramulator.simulate("scheme_i", tr, 16, alpha=1.0, r=0.25,
                              device=CPU).completed


# ------------------------------------------------------ randomized plans
PLAN_SCHEMES = ["scheme_i", "scheme_ii", "scheme_iii", "replication_2",
                "uncoded"]
_read_jax = jax.jit(jctl.build_read_pattern, static_argnums=0)
_write_jax = jax.jit(jctl.build_write_pattern, static_argnums=0)
_recode_jax = jax.jit(jrecode_step, static_argnums=0)


@functools.lru_cache(maxsize=None)
def _geom(scheme, n_rows=16, alpha=1.0, r=0.25, rc_cap=8):
    jt = jcodes.get_tables(scheme)
    jp = jstate.make_params(jt, n_rows=n_rows, alpha=alpha, r=r,
                            recode_cap=rc_cap)
    tt = codes.get_tables(scheme)
    tp = state.make_params(tt, n_rows=n_rows, alpha=alpha, r=r,
                           recode_cap=rc_cap)
    op = oracle.OracleParams.derive(n_rows, alpha, r, n_data=jt.n_data,
                                    recode_cap=rc_cap)
    om = oracle.OracleMemorySystem(scheme, op, n_cores=4)
    return jt, jp, jctl.jtables(jt), tp, ctl.jtables(tt), om


def _rand_state(rng, jt, p, n_rows=16, n=24):
    """A random reachable controller state and candidate set (the
    randomization of ``tests/test_conformance.py``)."""
    nb = p.n_data
    n_logical = len(jt.scheme.members)
    fresh = np.asarray(rng.integers(0, n_logical + 1, (nb, n_rows))
                       * (rng.random((nb, n_rows)) < 0.25), np.int32)
    pv = rng.random((p.n_parities, p.n_slots * p.region_size)) < 0.7
    rslot = np.full(p.n_regions, -1, np.int32)
    k = rng.integers(0, min(p.n_slots, p.n_regions) + 1)
    rslot[rng.permutation(p.n_regions)[:k]] = rng.permutation(p.n_slots)[:k]
    cap = p.recode_cap
    rcv = np.zeros(cap, bool)
    rcv[rng.permutation(cap)[:int(rng.integers(0, cap + 1))]] = True
    rcb = np.where(rcv, rng.integers(0, nb, cap), -1).astype(np.int32)
    rcr = np.where(rcv, rng.integers(0, n_rows, cap), -1).astype(np.int32)
    parked = rng.integers(0, 3, p.n_regions).astype(np.int32)
    cb = rng.integers(0, nb, n).astype(np.int32)
    ci = rng.integers(0, n_rows, n).astype(np.int32)
    ca = rng.integers(0, 50, n).astype(np.int32)     # age ties likely
    cv = rng.random(n) < 0.8
    pb = np.append(rng.random(p.n_ports) < 0.3, False)
    return fresh, pv, rslot, parked, rcb, rcr, rcv, cb, ci, ca, cv, pb


def _assert_fields(got, want, label):
    for name in want._fields:
        g = getattr(got, name)
        np.testing.assert_array_equal(
            g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g),
            np.asarray(getattr(want, name)), err_msg=f"{label}: {name}")


@pytest.mark.parametrize("scheme", PLAN_SCHEMES)
def test_plans_match_jax_and_oracle(scheme):
    """Read and write plans on random states equal the JAX builders' and
    the golden model's, field for field."""
    jt, jp, jtab, tp, ttab, om = _geom(scheme)
    for seed in range(6):
        rng = np.random.default_rng(seed)
        (fresh, pv, rslot, parked, rcb, rcr, rcv, cb, ci, ca, cv,
         pb) = _rand_state(rng, jt, jp)
        label = f"{scheme} seed={seed}"
        rin = (cb, ci, ca, cv, pb, fresh, pv, rslot)
        got = ctl.build_read_pattern(tp, ttab, *map(_t, rin))
        _assert_fields(got, _read_jax(jp, jtab, *map(jnp.asarray, rin)),
                       "ReadPlan vs JAX " + label)
        _assert_fields(got, oracle.build_read_plan(om, *rin),
                       "ReadPlan vs oracle " + label)
        win = rin + (parked, rcb, rcr, rcv)
        got = ctl.build_write_pattern(tp, ttab, *map(_t, win))
        _assert_fields(got, _write_jax(jp, jtab, *map(jnp.asarray, win)),
                       "WritePlan vs JAX " + label)
        _assert_fields(got, oracle.build_write_plan(om, *win),
                       "WritePlan vs oracle " + label)


@pytest.mark.parametrize("scheme", ["scheme_i", "scheme_ii", "scheme_iii"])
def test_recode_matches_jax_and_oracle(scheme):
    jt, jp, jtab, tp, ttab, om = _geom(scheme)
    for seed in range(6):
        rng = np.random.default_rng(1000 + seed)
        fresh, pv, rslot, parked, rcb, rcr, rcv = _rand_state(rng, jt, jp)[:7]
        pb = np.append(rng.random(jp.n_ports) < 0.3, False)
        banks = rng.integers(0, 1 << 20, (jp.n_data, 16)).astype(np.int32)
        pdata = rng.integers(0, 1 << 20, pv.shape).astype(np.int32)
        args = (pb, fresh, pv, parked, rcb, rcr, rcv, rslot, banks, pdata)
        got = recode_step(tp, ttab, *map(_t, args))
        label = f"RecodeOut {scheme} seed={seed}"
        _assert_fields(got, _recode_jax(jp, jtab, *map(jnp.asarray, args)),
                       label + " vs JAX")
        _assert_fields(got, oracle.recode_step(om, *args),
                       label + " vs oracle")


# ------------------------------------------------------------- the cycle
def _systems(scheme, n_rows=32, alpha=0.25, r=0.125, n_cores=4,
             select_period=16, **kw):
    """The JAX system and the port's on the CPU, configured alike (the
    ``tests/test_conformance.py`` geometry)."""
    jt = jcodes.get_tables(scheme)
    jp = jstate.make_params(jt, n_rows=n_rows, alpha=alpha, r=r,
                            recode_cap=8, **kw)
    jtn = jstate.make_tunables(queue_depth=jp.queue_depth,
                               select_period=select_period)
    tt = codes.get_tables(scheme)
    tp = state.make_params(tt, n_rows=n_rows, alpha=alpha, r=r, recode_cap=8,
                           **kw)
    ttn = state.make_tunables(queue_depth=tp.queue_depth,
                              select_period=select_period)
    return (jsys.CodedMemorySystem(jt, jp, n_cores=n_cores, tunables=jtn),
            system.CodedMemorySystem(tt, tp, n_cores=n_cores, tunables=ttn,
                                     device=CPU))


@pytest.fixture(scope="module")
def per_cycle_systems():
    return _systems("scheme_i", alpha=0.25, r=0.125)


def test_per_cycle_datapath_matches_jax(per_cycle_systems):
    """Cycle by cycle, 64 cycles of scheme_i at α=0.25, r=0.125: which
    reads are served, from where, and the values the read datapath returns
    (mirrors ``test_per_cycle_datapath_conformance``). The same cycles also
    hold the memory-order invariant: a served read returns the golden
    value committed before the cycle."""
    jsys_, tsys_ = per_cycle_systems
    om = oracle.OracleMemorySystem(
        "scheme_i", oracle.OracleParams.derive(32, 0.25, 0.125,
                                               recode_cap=8,
                                               select_period=16),
        n_cores=4)
    trace = rand_trace(np.random.default_rng(3), 4, 16, 8, 32)
    ttr = _jtrace_to_port(trace)
    tr_np = tuple(np.asarray(x) for x in trace)
    jst, tst, ost = jsys_.init(), tsys_.init(), om.init_state()
    served = 0
    for cyc in range(64):
        golden = tst.mem.golden.clone()
        jst, jout = jsys_.cycle_fn(jst, trace)
        tst, tout = tsys_.cycle_fn(tst, ttr)
        oout = om.cycle(ost, tr_np)
        for name in system.CycleOut._fields:
            got = getattr(tout, name).numpy()
            np.testing.assert_array_equal(
                got, np.asarray(getattr(jout, name)),
                err_msg=f"cycle {cyc}: {name} vs JAX")
            np.testing.assert_array_equal(
                got, getattr(oout, name), err_msg=f"cycle {cyc}: {name}")
        s = tout.r_served
        assert torch.equal(tout.r_value[s],
                           golden[tout.r_bank[s].long(), tout.r_row[s].long()])
        served += int(s.sum())
    assert served > 10
    assert_states_equal(jst, tst, "per-cycle run")


FULL_RUNS = [("uncoded", 1.0), ("scheme_i", 1.0), ("scheme_i", 0.25),
             ("scheme_ii", 0.25), ("scheme_iii", 1.0),
             ("replication_2", 1.0)]


@pytest.fixture(scope="module")
def small_trace():
    spec = jtrace.TraceSpec(n_cores=4, length=24, n_banks=8, n_rows=64,
                            write_frac=0.4, seed=2)
    return jtrace.banded_trace(spec)


@pytest.mark.parametrize("scheme,alpha", FULL_RUNS)
def test_full_run_matches_jax(scheme, alpha, small_trace):
    """A full ``simulate`` run at n_rows=64, 4 cores, length 24: the port's
    SimResult and every final state leaf equal the JAX system's, run the
    way JAX's ``simulate`` runs it (all ``default_n_cycles`` cycles). A
    short select period makes the α < 1 runs switch regions."""
    kw = dict(alpha=alpha, r=0.125, select_period=8)
    jt = jcodes.get_tables(scheme)
    jp = jstate.make_params(jt, n_rows=64, alpha=alpha, r=0.125)
    jtn = jstate.make_tunables(queue_depth=jp.queue_depth, select_period=8)
    jsys_ = jsys.CodedMemorySystem(jt, jp, n_cores=4, tunables=jtn)
    n = jram.default_n_cycles(small_trace)
    jst, _ = jsys_._run(jsys_.init(), small_trace, n)
    want = jsys_.summarize(jst)
    tr = system.Trace(*(x.clone() for x in _jtrace_to_port(small_trace)))
    before = enc_ops_calls()
    got, tst = ramulator.simulate(scheme, tr, 64, device=CPU,
                                  return_state=True, **kw)
    assert got == want
    assert_states_equal(jst, tst, f"{scheme} α={alpha}")
    assert bool(system.quiescent(tst)) == bool(jsys.quiescent(jst))
    if alpha < 1:
        assert got.switches > 0
        # one region encode per completed switch, through the wrapper
        assert enc_ops_calls() - before == got.switches


def enc_ops_calls():
    return enc_ops.calls


def test_simulate_entry_point_matches_jax(small_trace):
    """JAX's own ``simulate`` and the port's, same arguments."""
    want = jram.simulate("scheme_i", small_trace, 64, alpha=0.25, r=0.125,
                         select_period=8)
    got = ramulator.simulate("scheme_i", _jtrace_to_port(small_trace), 64,
                             alpha=0.25, r=0.125, select_period=8,
                             device=CPU)
    assert got == want
    base = ramulator.simulate("uncoded", _jtrace_to_port(small_trace), 64,
                              alpha=1.0, r=0.125, device=CPU)
    assert ramulator.cycle_reduction(base, got) == jram.cycle_reduction(
        jram.simulate("uncoded", small_trace, 64, alpha=1.0, r=0.125), want)
    both = ramulator.compare_schemes(_jtrace_to_port(small_trace), 64,
                                     alpha=0.25, r=0.125, select_period=8,
                                     schemes=("uncoded", "scheme_i"),
                                     device=CPU)
    assert both["scheme_i"] == got


def test_mid_run_state_carried_from_jax(per_cycle_systems):
    """A JAX state 40 cycles into a run, carried into the port by
    ``convert.sim_state_from_numpy`` and stepped 16 more cycles, equals
    JAX stepped 16 more; and it converts back unchanged."""
    jsys_, tsys_ = per_cycle_systems
    trace = rand_trace(np.random.default_rng(9), 4, 24, 8, 32,
                       write_frac=0.6)
    jst, _ = jsys_._run(jsys_.init(), trace, 40)
    tst = convert.sim_state_from_numpy(jax.device_get(jst), CPU)
    assert_states_equal(jst, tst, "carried")
    jst, _ = jsys_._run(jst, trace, 16)
    tst, _ = tsys_._run(tst, _jtrace_to_port(trace), 16)
    assert_states_equal(jst, tst, "carried + 16 cycles")


def test_read_values_go_through_gather_decode(per_cycle_systems):
    """The cycle's read datapath is ``xor_gather.ops.gather_plan`` (the
    coded row gather fed the plan; once per read-branch cycle) on the
    banks' 4-byte rows."""
    _, tsys_ = per_cycle_systems
    trace = _jtrace_to_port(rand_trace(np.random.default_rng(4), 4, 8, 8,
                                       32, write_frac=0.0))
    before = g_ops.calls
    st, _ = tsys_._run(tsys_.init(), trace, 12)
    assert g_ops.calls - before == 12         # no writes: every cycle reads
    assert int(st.mem.served_reads) == int(trace.valid.sum())


@pytest.mark.parametrize("scheme", ["scheme_i", "scheme_ii", "scheme_iii"])
def test_reads_return_committed_values(scheme):
    """The datapath invariant on the port alone (mirrors
    ``tests/test_system.py::test_reads_return_committed_values``): every
    served read equals the golden value committed before its cycle, across
    direct, degraded, redirect and chained-decode reads."""
    t = codes.get_tables(scheme)
    p = state.make_params(t, n_rows=64, alpha=1.0, r=0.25)
    sys_ = system.CodedMemorySystem(t, p, n_cores=4, device=CPU)
    trace = _jtrace_to_port(rand_trace(np.random.default_rng(1), 4, 24, 8,
                                       64, write_frac=0.4))
    st = sys_.init()
    checked = 0
    for _ in range(96):
        golden = st.mem.golden
        st, out = sys_.cycle_fn(st, trace)
        s = out.r_served
        assert torch.equal(out.r_value[s], golden[out.r_bank[s].long(),
                                                  out.r_row[s].long()])
        checked += int(s.sum())
        if int(st.done_cycle) >= 0:
            break
    assert checked > 10 and int(st.done_cycle) >= 0
    assert int(st.mem.degraded_reads) > 0


def test_trace_past_the_geometry_is_rejected():
    """A row or bank past the system's geometry raises before the run (JAX
    would clamp it silently; torch would fault)."""
    t = codes.get_tables("scheme_i")
    p = state.make_params(t, n_rows=16, alpha=1.0, r=0.25)
    sys_ = system.CodedMemorySystem(t, p, n_cores=2, device=CPU)
    tr = _jtrace_to_port(rand_trace(np.random.default_rng(0), 2, 4, 8, 16))
    sys_.run(tr, 8)
    for field in ("row", "bank"):
        bad = tr._replace(**{field: getattr(tr, field).clone()})
        getattr(bad, field)[1, 2] = 16 if field == "row" else 8
        with pytest.raises(ValueError, match="trace reaches"):
            sys_.run(bad, 8)
