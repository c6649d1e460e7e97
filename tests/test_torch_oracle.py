"""The port's golden model of the memory cycle (``repro_torch.oracle.codes``
and ``model``) and its bridge to the simulator (``repro_torch.sim.golden``)
on the CPU.

Three layers, each asserting equality, not closeness:

1. *the copy is JAX's code*: the syntax trees of the port's modules equal
   the JAX package's, the package name mapped and docstrings dropped;
2. *the copy is JAX's oracle by results*: scheme tables (and their hash
   against the port's core tables and certificate), read/write plans and
   recodes on random states, full workloads, a telemetry-on run, a
   fault-plan run and the masked α×r grid, field for field;
3. *the port's core is the port's oracle*, through ``sim.golden``: the
   per-cycle datapath, full workloads, streamed replay, the masked grid,
   telemetry planes and fault leaves; and ``state_mismatches`` names the
   field that differs.

Inputs are made with numpy from a seed and handed to every side."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import rand_trace
from test_torch_sim import _jtrace_to_port, _rand_state

from repro import oracle as joracle
from repro_torch import oracle as toracle
from repro_torch.analysis import schemes as tanl
from repro_torch.core import codes, controller as ctl, state, system
from repro_torch.core.recoding import recode_step
from repro_torch.faults import FaultPlan
from repro_torch.sim import golden
from repro_torch.sweep import SweepPoint, grid, partition, run_points
from repro_torch.sweep.workloads import build_trace
from repro_torch.traces import stream_replay

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
SCHEMES = ["scheme_i", "scheme_ii", "scheme_iii", "replication_2", "uncoded"]
# tests/test_conformance.py's full workloads
WORKLOADS = [("scheme_i", 1.0, 0.25), ("scheme_i", 0.25, 0.125),
             ("uncoded", 1.0, 0.25), ("replication_2", 0.25, 0.125),
             ("scheme_ii", 0.5, 0.125), ("scheme_iii", 1.0, 0.25)]


# ------------------------------------------------------ 1. the same code
def _code_dump(path: Path, package: str) -> str:
    """The module's syntax tree without docstrings, its imports of
    ``<package>.oracle`` renamed to ``oracle``."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith(package + ".oracle"):
            node.module = node.module[len(package) + 1:]
    return ast.dump(tree, include_attributes=False)


@pytest.mark.parametrize("name", ["codes.py", "model.py"])
def test_copy_is_jax_code(name):
    """Apart from the package name and docstrings, the port's module is
    the JAX package's, statement for statement."""
    want = _code_dump(ROOT / "src" / "repro" / "oracle" / name, "repro")
    got = _code_dump(ROOT / "src" / "repro_torch" / "oracle" / name,
                     "repro_torch")
    assert got == want


def test_exports_match_jax():
    public = {n for n in dir(joracle) if not n.startswith("_")}
    assert {n for n in dir(toracle) if not n.startswith("_")} == public
    assert (toracle.MAX_OPTS, toracle.MAX_SIBS) == (joracle.MAX_OPTS,
                                                     joracle.MAX_SIBS)
    assert toracle.ORACLE_SCHEMES == joracle.ORACLE_SCHEMES


def test_mode_numbering_contract():
    """Plan modes are compared elementwise, so the numbering is a shared
    contract between the port's oracle and its controller."""
    assert (toracle.MODE_FROM_SYM, toracle.MODE_DIRECT, toracle.MODE_OPT0,
            toracle.MODE_REDIRECT, toracle.MODE_UNSERVED) == (
        ctl.MODE_FROM_SYM, ctl.MODE_DIRECT, ctl.MODE_OPT0, ctl.MODE_REDIRECT,
        ctl.MODE_UNSERVED)
    assert (toracle.WMODE_DIRECT, toracle.WMODE_PARK0, toracle.WMODE_UNSERVED
            ) == (ctl.WMODE_DIRECT, ctl.WMODE_PARK0, ctl.WMODE_UNSERVED)


# ------------------------------------------------- 2. JAX's oracle's results
@pytest.mark.parametrize("scheme", SCHEMES + ["replication_4"])
def test_tables_match_jax_oracle_and_core(scheme):
    """The copy's tables equal JAX's oracle's and the port's core tables;
    both hash to the port's certificate (``test_conformance.py:49``)."""
    t = codes.get_tables(scheme)
    o = toracle.oracle_scheme(scheme, t.n_data)
    j = joracle.oracle_scheme(scheme, t.n_data)
    assert (o.name, o.n_data, o.members, o.phys) == (j.name, j.n_data,
                                                     j.members, j.phys)
    assert [o.options(b) for b in range(o.n_data)] == \
        [j.options(b) for b in range(j.n_data)]
    cert = tanl.load_certificates()["schemes"][scheme]["table_sha256"]
    assert tanl.table_hash(o.members, o.phys) == cert
    assert tanl.table_hash(t.scheme.members, t.scheme.phys) == cert
    assert o.n_ports == t.n_ports and o.n_parities == len(t.scheme.members)
    for jj in range(o.n_parities):
        assert o.par_port(jj) == int(t.par_port[jj])
    for b in range(o.n_data):
        opts = o.options(b)
        assert len(opts) == int(t.opt_n[b])
        for k, (jj, sibs) in enumerate(opts):
            assert jj == int(t.opt_parity[b, k])
            assert sibs == tuple(int(s) for s in t.opt_sibs[b, k] if s >= 0)


def _oracles(scheme, n_rows=16, alpha=1.0, r=0.25, rc_cap=8):
    """The port's oracle and JAX's at one geometry, with the port's core
    params and tables."""
    tt = codes.get_tables(scheme)
    tp = state.make_params(tt, n_rows=n_rows, alpha=alpha, r=r,
                           recode_cap=rc_cap)
    kw = dict(n_data=tt.n_data, recode_cap=rc_cap)
    return (toracle.OracleMemorySystem(
                scheme, toracle.OracleParams.derive(n_rows, alpha, r, **kw),
                n_cores=4),
            joracle.OracleMemorySystem(
                scheme, joracle.OracleParams.derive(n_rows, alpha, r, **kw),
                n_cores=4),
            tt, tp, ctl.jtables(tt))


def _assert_fields(got, want, label):
    for name in want._fields:
        g = getattr(got, name)
        np.testing.assert_array_equal(
            g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g),
            np.asarray(getattr(want, name)), err_msg=f"{label}: {name}")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_plans_match_jax_oracle_and_core(scheme):
    """Read and write plans on random states: the copy's equal JAX's
    oracle's and the port's controller's, field for field."""
    om, jm, tt, tp, ttab = _oracles(scheme)
    for seed in range(6):
        rng = np.random.default_rng(seed)
        (fresh, pv, rslot, parked, rcb, rcr, rcv, cb, ci, ca, cv,
         pb) = _rand_state(rng, tt, tp)
        label = f"{scheme} seed={seed}"
        rin = (cb, ci, ca, cv, pb, fresh, pv, rslot)
        got = toracle.build_read_plan(om, *rin)
        _assert_fields(got, joracle.build_read_plan(jm, *rin),
                       "ReadPlan vs JAX's oracle " + label)
        _assert_fields(ctl.build_read_pattern(tp, ttab, *map(_t, rin)), got,
                       "ReadPlan of the core " + label)
        win = rin + (parked, rcb, rcr, rcv)
        got = toracle.build_write_plan(om, *win)
        _assert_fields(got, joracle.build_write_plan(jm, *win),
                       "WritePlan vs JAX's oracle " + label)
        _assert_fields(ctl.build_write_pattern(tp, ttab, *map(_t, win)), got,
                       "WritePlan of the core " + label)


@pytest.mark.parametrize("scheme", ["scheme_i", "scheme_ii", "scheme_iii"])
def test_recode_matches_jax_oracle_and_core(scheme):
    om, jm, tt, tp, ttab = _oracles(scheme)
    for seed in range(6):
        rng = np.random.default_rng(1000 + seed)
        fresh, pv, rslot, parked, rcb, rcr, rcv = _rand_state(rng, tt, tp)[:7]
        pb = np.append(rng.random(tp.n_ports) < 0.3, False)
        banks = rng.integers(0, 1 << 20, (tp.n_data, 16)).astype(np.int32)
        pdata = rng.integers(0, 1 << 20, pv.shape).astype(np.int32)
        args = (pb, fresh, pv, parked, rcb, rcr, rcv, rslot, banks, pdata)
        got = toracle.recode_step(om, *args)
        label = f"RecodeOut {scheme} seed={seed}"
        _assert_fields(got, joracle.recode_step(jm, *args),
                       label + " vs JAX's oracle")
        _assert_fields(recode_step(tp, ttab, *map(_t, args)), got,
                       label + " of the core")


def _assert_ostates_equal(got, want, label):
    """Two oracle states (the copy's, JAX's) field for field, the
    telemetry and fault dataclasses included."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(b):
            _assert_ostates_equal(a, b, f"{label}: {f.name}")
        elif b is None:
            assert a is None, f"{label}: {f.name}"
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{label}: {f.name}")
            assert np.asarray(a).dtype == np.asarray(b).dtype, \
                f"{label}: {f.name} dtype"


def _system(scheme, n_rows=32, alpha=0.25, r=0.125, n_cores=4,
            select_period=16, **kw):
    """The port's system at ``tests/test_conformance.py``'s geometry."""
    tt = codes.get_tables(scheme)
    tp = state.make_params(tt, n_rows=n_rows, alpha=alpha, r=r, recode_cap=8,
                           **kw)
    tn = state.make_tunables(queue_depth=tp.queue_depth,
                             select_period=select_period)
    return system.CodedMemorySystem(tt, tp, n_cores=n_cores, tunables=tn,
                                    device=CPU)


def _jax_twin(sys_):
    """JAX's oracle configured as the port's twin of ``sys_``."""
    op = golden.oracle_twin(sys_).p
    return joracle.OracleMemorySystem(sys_.tables.scheme.name,
                                      joracle.OracleParams(
                                          **dataclasses.asdict(op)),
                                      n_cores=sys_.n_cores)


def _check_three(sys_, trace, n_cycles, label, fault_plan=None):
    """The port's core, its oracle and JAX's oracle over one workload:
    every field of both oracles' states and results equal, and the core's
    every state field (planes, fault leaf) and result equal its twin's."""
    twin = golden.oracle_twin(sys_)
    tr_np = golden.host_trace(trace)
    ost = twin.run(tr_np, n_cycles, st=twin.init_state(fault_plan=fault_plan))
    jm = _jax_twin(sys_)
    jst = jm.run(tr_np, n_cycles, st=jm.init_state(fault_plan=fault_plan))
    _assert_ostates_equal(ost, jst, label)
    assert twin.result(ost) == jm.result(jst), label
    st, _ = sys_._run(sys_.init(fault_plan=fault_plan), trace, n_cycles)
    assert golden.state_mismatches(st, ost) == [], label
    res = sys_.summarize(st)
    assert golden.result_matches(res, twin.result(ost)), label
    return res, ost


@pytest.mark.parametrize("scheme,alpha,r", WORKLOADS)
def test_full_workload(scheme, alpha, r):
    """``test_conformance.py``'s full workloads (96 cycles, 4 cores x 20
    requests, write fractions 0.45 and 0.7): JAX's oracle = the copy =
    the port's core, every state field and statistic."""
    sys_ = _system(scheme, alpha=alpha, r=r)
    for seed, wf in ((7, 0.45), (8, 0.7)):
        trace = _jtrace_to_port(rand_trace(np.random.default_rng(seed), 4,
                                           20, sys_.p.n_data, 32,
                                           write_frac=wf))
        res, _ = _check_three(sys_, trace, 96,
                              f"{scheme} α={alpha} r={r} seed={seed}")
        assert res.served_reads + res.served_writes > 0


@pytest.mark.parametrize("scheme", ["scheme_i", "scheme_iii"])
def test_telemetry_run(scheme):
    """Telemetry on: the planes of the core, the copy's
    ``OracleTelemetry`` and JAX's agree after 128 cycles."""
    sys_ = _system(scheme, n_rows=64, telemetry=True)
    trace = _jtrace_to_port(rand_trace(np.random.default_rng(7), 4, 20, 8,
                                       64))
    _, ost = _check_three(sys_, trace, 128, f"{scheme} telemetry")
    assert ost.tele is not None and ost.tele.lat_hist_read.sum() > 0


@pytest.mark.parametrize("scheme,alpha,r", [("scheme_i", 1.0, 0.25),
                                            ("scheme_iii", 0.25, 0.125)])
def test_fault_plan_run(scheme, alpha, r):
    """A dead bank that rebuilds and a stuttering parity port, telemetry
    on: the fault leaf and planes of the core, the copy and JAX's oracle
    agree, and reads were served degraded because a bank was down."""
    sys_ = _system(scheme, alpha=alpha, r=r, faults=True, telemetry=True)
    plan = FaultPlan.from_spec((("bank", 1, 5, 60), ("stutter", 8, 3, 1)),
                               sys_.p.n_data, sys_.p.n_ports)
    trace = _jtrace_to_port(rand_trace(np.random.default_rng(11), 4, 24,
                                       sys_.p.n_data, 32))
    res, ost = _check_three(sys_, trace, 160, f"{scheme} faults", plan)
    assert ost.fault is not None and res.dead_bank_cycles > 0
    assert res.fault_degraded_reads + res.unserved_reads > 0


def _grid(scheme):
    t = codes.get_tables(scheme)
    base = SweepPoint(scheme=scheme, n_rows=32, n_cores=3, n_banks=t.n_data,
                      n_data=t.n_data, length=10, select_period=16,
                      recode_cap=8)
    return grid(base, alpha=(0.25, 0.5), r=(0.125, 0.25))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_masked_geometry_grid(scheme):
    """An α×r grid runs as one padded batch per scheme. Each point equals
    the copy's oracle run at the point's own exact geometry
    (``OracleParams.derive``), which equals JAX's; and each point's final
    state equals its padded twin (``golden.point_twins``) over the
    batch's cycles, field for field."""
    pts = _grid(scheme)
    assert len({pt.derived_slots() for pt in pts}) > 1
    assert len(partition(pts)) == 1
    res, states = run_points(pts, device=CPU, return_state=True)
    for pt, r, st, twin in zip(pts, res, states, golden.point_twins(pts)):
        kw = dict(n_data=pt.n_data, recode_cap=pt.recode_cap,
                  select_period=pt.select_period, wq_hi=pt.wq_hi,
                  wq_lo=pt.wq_lo, queue_depth=pt.queue_depth)
        tr = golden.host_trace(build_trace(pt, device=CPU))
        om = toracle.OracleMemorySystem(
            scheme, toracle.OracleParams.derive(pt.n_rows, pt.alpha, pt.r,
                                                **kw), n_cores=pt.n_cores)
        jm = joracle.OracleMemorySystem(
            scheme, joracle.OracleParams.derive(pt.n_rows, pt.alpha, pt.r,
                                                **kw), n_cores=pt.n_cores)
        ost = om.run(tr, pt.resolved_cycles(), stop_when_quiescent=True)
        jst = jm.run(tr, pt.resolved_cycles(), stop_when_quiescent=True)
        assert om.result(ost) == jm.result(jst), pt
        assert golden.result_matches(r, om.result(ost)), pt
        assert golden.check_run(st, r, twin, build_trace(pt, device=CPU),
                                int(st.mem.cycle)) == [], pt


# ------------------------------------------------ 3. the core is the oracle
def test_per_cycle_datapath():
    """Cycle by cycle, 64 cycles of scheme_i at α=0.25: every ``CycleOut``
    of the core equals the copy's, which equals JAX's oracle's
    (``test_per_cycle_datapath_conformance``)."""
    sys_ = _system("scheme_i")
    twin = golden.oracle_twin(sys_)
    jm = _jax_twin(sys_)
    trace = _jtrace_to_port(rand_trace(np.random.default_rng(3), 4, 16, 8,
                                       32))
    tr_np = golden.host_trace(trace)
    st, ost, jst = sys_.init(), twin.init_state(), jm.init_state()
    for cyc in range(64):
        st, out = sys_.cycle_fn(st, trace)
        oout = twin.cycle(ost, tr_np)
        jout = jm.cycle(jst, tr_np)
        for name in system.CycleOut._fields:
            np.testing.assert_array_equal(getattr(oout, name),
                                          getattr(jout, name),
                                          err_msg=f"cycle {cyc}: {name}")
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          getattr(oout, name),
                                          err_msg=f"cycle {cyc}: {name}")
    assert golden.state_mismatches(st, ost) == []
    _assert_ostates_equal(ost, jst, "per-cycle run")


@pytest.mark.parametrize("chunk_len", [1, 3, 14])
def test_streamed_replay(chunk_len):
    """Streamed replay at any chunk length equals the oracle's run to
    quiescence (``check_stream_conformance``)."""
    sys_ = _system("scheme_i", n_cores=3)
    trace = _jtrace_to_port(rand_trace(np.random.default_rng(5), 3, 10, 8,
                                       32))
    got = stream_replay(sys_, trace, chunk_len=chunk_len)
    twin = golden.oracle_twin(sys_)
    ost = twin.run(golden.host_trace(trace), system.drain_bound(3, 10),
                   stop_when_quiescent=True)
    assert golden.result_matches(got, twin.result(ost))
    assert golden.result_mismatches(got, twin.result(ost)) == []


def test_twin_of_a_padded_batch_point():
    """``oracle_twin`` with batched tunables takes the point's own
    geometry; INT32_MAX ``*_active`` values mean the allocation."""
    pts = _grid("scheme_i")
    batch = partition(pts)[0]
    twins = golden.batch_twins(batch.points)
    for pt, twin in zip(batch.points, twins):
        rs, nr, ns = pt.derived_slots()
        assert (twin.p.rs_active, twin.p.nr_active, twin.p.slot_budget) == (
            rs, nr, ns)
    sys_ = _system("scheme_i")
    op = golden.oracle_twin(sys_).p
    assert (op.region_size_active, op.n_regions_active) == (
        sys_.p.region_size, sys_.p.n_regions)
    assert op.n_slots_active == sys_.p.n_active


def test_state_mismatches_names_the_field():
    """A port state equal to its twin gives no names; a flipped lane bit,
    a wide counter, a plane, a fault field and a missing leaf are each
    named; a batched state is read at its ``point``."""
    sys_ = _system("scheme_i", faults=True, telemetry=True)
    traces = [_jtrace_to_port(rand_trace(np.random.default_rng(s), 4, 20, 8,
                                         32)) for s in (21, 22)]
    twin = golden.oracle_twin(sys_)
    st, _ = sys_._run(sys_.init(), traces[1], 48)
    ost = twin.run(golden.host_trace(traces[1]), 48)
    assert golden.state_mismatches(st, ost) == []
    m = st.mem
    banks = m.banks_data.clone()
    banks[0, 0] ^= torch.tensor(-(1 << 31), dtype=torch.int32)  # sign bit
    bad = st._replace(mem=m._replace(
        banks_data=banks, stall_cycles=m.stall_cycles + 1,
        tele=m.tele._replace(rq_hwm=m.tele.rq_hwm + 1),
        fault=m.fault._replace(rebuilt=~m.fault.rebuilt)))
    assert golden.state_mismatches(bad, ost) == [
        "banks_data", "stall_cycles", "tele.rq_hwm", "fault.rebuilt"]
    assert golden.state_mismatches(
        st._replace(mem=m._replace(tele=None)), ost) == [
            "tele (present on one side only)"]
    other, _ = sys_._run(sys_.init(), traces[0], 48)
    pair = _stack([other, st])
    assert golden.state_mismatches(pair, ost, point=1) == []
    assert golden.state_mismatches(pair, ost, point=0) != []
    res = sys_.summarize(st)
    assert golden.result_mismatches(
        res._replace(switches=res.switches + 1), twin.result(ost)) == [
            "switches"]


def _stack(states):
    """One batched state of several points' states."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(states)
    if isinstance(first, tuple):
        return type(first)(*(_stack([s[i] for s in states])
                             for i in range(len(first))))
    return first
