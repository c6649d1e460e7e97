"""The port's telemetry planes (``repro_torch.obs``) on the CPU against the
JAX package and its NumPy oracle, bit for bit by value: the flag off
carries no planes and changes nothing, the field layout, the plane sums
against the aggregates, stalls under queue pressure, every plane of a
batch whose points disagree on read/write against JAX's ``run`` and the
oracle's ``OracleTelemetry``, ``lat_bin``, ``run_points``'
snapshots, the histogram windows of streamed replay (with kill-and-resume),
``convert`` of the ``tele`` leaf, the stall and availability reports and
the timeline (mirrors ``tests/test_obs.py``).

Inputs are made with numpy from a seed (64 rows, 2-8 cores, lengths
10-32) and handed to both sides; the JAX systems are built once."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import assert_state_matches_oracle, oracle_twin, rand_trace
from test_torch_sim import _jtrace_to_port, assert_states_equal

import repro.obs as jobs
from repro.core import codes as jcodes
from repro.core import state as jstate
from repro.core import system as jsys
from repro.obs import planes as jplanes
from repro.obs import report as jreport
from repro.obs import timeline as jtimeline
from repro.oracle.model import _lat_bin as oracle_lat_bin
from repro.sweep import SweepPoint as JPoint
from repro.sweep import run_points as jrun_points
from repro.sweep.grid import static_signature as jsignature
from repro.sweep.workloads import build_trace as jbuild_trace
from repro.traces.stream import stream_replay as jstream_replay
from repro.traces.stream import stream_replay_points as jstream_points
import repro_torch.obs as tobs
from repro_torch import convert
from repro_torch.core import codes, state, system
from repro_torch.obs import planes, report, timeline
from repro_torch.sweep import SweepPoint, run_points, static_signature
from repro_torch.sweep.workloads import build_trace
from repro_torch.traces import stream_replay, stream_replay_points

CPU = "cpu"
N_CYCLES = 96


@functools.lru_cache(maxsize=None)
def _systems(scheme="scheme_i", telemetry=True, n_cores=4, queue_depth=10):
    """A JAX system and the port's twin at ``tests/test_obs.py``'s
    geometry (64 rows, alpha 0.25, r 0.125, ring of 8, select period 16),
    built once."""
    jt = jcodes.get_tables(scheme)
    jp = jstate.make_params(jt, n_rows=64, alpha=0.25, r=0.125,
                            recode_cap=8, telemetry=telemetry,
                            queue_depth=queue_depth)
    js = jsys.CodedMemorySystem(jt, jp, n_cores=n_cores,
                                tunables=jstate.make_tunables(
                                    queue_depth=queue_depth,
                                    select_period=16))
    tt = codes.get_tables(scheme)
    tp = state.make_params(tt, n_rows=64, alpha=0.25, r=0.125,
                           recode_cap=8, telemetry=telemetry,
                           queue_depth=queue_depth)
    ts = system.CodedMemorySystem(tt, tp, n_cores=n_cores, device=CPU,
                                  tunables=state.make_tunables(
                                      queue_depth=queue_depth,
                                      select_period=16))
    return js, ts


def _trace(n_cores=4, seed=7, length=20, write_frac=0.45):
    rng = np.random.default_rng(seed)
    return rand_trace(rng, n_cores, length, 8, 64, write_frac=write_frac)


def assert_planes_match_oracle(tele, ost, label=""):
    """One point's port planes equal the oracle's ``OracleTelemetry``."""
    assert ost.tele is not None, label
    for name in planes.Telemetry._fields:
        np.testing.assert_array_equal(
            getattr(tele, name).cpu().numpy().astype(np.int64),
            np.asarray(getattr(ost.tele, name)),
            err_msg=f"{label}: tele.{name}")


def assert_snapshots_equal(got, want, label=""):
    """Two ``TelemetrySnapshot``s (port, JAX) plane for plane, or both
    None."""
    assert (got is None) == (want is None), label
    if want is None:
        return
    for name in planes.Telemetry._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name),
                                      err_msg=f"{label}: {name}")
    assert got.as_dict() == want.as_dict(), label


# ------------------------------------------------ 1. telemetry off is inert
def test_off_state_carries_no_planes():
    """Telemetry off: the ``tele`` leaf is None (one point and a batch).
    On: JAX's initial planes, shapes and values, with int64 counters and
    int32 high-water marks and provenance carriers."""
    _, off = _systems(telemetry=False)
    assert not off.p.telemetry and off.init().mem.tele is None
    assert off.init_batch(off.batch_tunables()).mem.tele is None
    js, ts = _systems()
    assert_states_equal(js.init(), ts.init(), "init")
    tele = ts.init().mem.tele
    for name, x in zip(planes.Telemetry._fields, tele):
        want = torch.int64 if name in planes.COUNTER_FIELDS else torch.int32
        assert x.dtype == want, name
    assert tuple(ts.init_batch(ts.batch_tunables()).mem.tele.rq_core.shape) \
        == (1, 8, 10)


def test_field_layout_matches_jax():
    """The planes' fields, the cause and class names and the flags' places
    are JAX's; ``repro_torch.obs`` exports ``repro.obs``'s names; the
    counters the port keeps as int64 are the ones JAX keeps as uint32; the
    flag keys the sweep's static signature as in JAX."""
    assert planes.Telemetry._fields == jplanes.Telemetry._fields
    for name in ("STALL_CAUSES", "WAIT_CAUSES", "READ_CLASSES",
                 "WRITE_CLASSES", "HIST_BINS", "WAIT_READ", "WAIT_WRITE",
                 "WAIT_RECODE"):
        assert getattr(planes, name) == getattr(jplanes, name), name
    assert tobs.__all__ == jobs.__all__
    assert all(hasattr(tobs, n) for n in tobs.__all__)
    jinit = jplanes.init_telemetry(8, 4, 10)
    assert set(planes.COUNTER_FIELDS) == {
        f for f, x in zip(jinit._fields, jinit) if x.dtype == jnp.uint32}
    assert state.MemParams._fields == jstate.MemParams._fields
    assert state.MemState._fields[-2:] == ("tele", "fault")
    assert state.MemState._field_defaults["tele"] is None
    tpt = SweepPoint(n_rows=64, length=32)
    jpt = JPoint(n_rows=64, length=32)
    on = static_signature(tpt.replace(telemetry=True))
    assert on != static_signature(tpt)
    assert on == jsignature(jpt.replace(telemetry=True))


def test_on_off_results_identical():
    """The planes change no statistic: the same SimResult, and every
    other leaf equal, telemetry on against off."""
    _, off = _systems(telemetry=False)
    _, on = _systems()
    tr = _jtrace_to_port(_trace())
    st_off, _ = off._run(off.init(), tr, N_CYCLES)
    st_on, _ = on._run(on.init(), tr, N_CYCLES)
    assert off.summarize(st_off) == on.summarize(st_on)
    for name, a, b in zip(state.MemState._fields, st_off.mem, st_on.mem):
        if name == "tele":
            assert a is None and b is not None
            continue
        assert (a is None and b is None) or torch.equal(a, b), name
    assert torch.equal(st_off.core_ptr, st_on.core_ptr)
    assert torch.equal(st_off.done_cycle, st_on.done_cycle)


# ------------------------------------------- 2. telemetry on, ground-truthed
def test_plane_sums_match_aggregates():
    """Each plane partitions an aggregate exactly: stalls by (bank, cause),
    served reads by (core, class), served writes by (core, mode), the
    histograms' mass."""
    _, ts = _systems()
    st, _ = ts._run(ts.init(), _jtrace_to_port(_trace()), N_CYCLES)
    res, snap = ts.summarize(st), planes.snapshot(st)
    assert snap.stall_total() == res.stall_cycles
    assert snap.served_reads() == res.served_reads > 0
    assert snap.served_writes() == res.served_writes > 0
    assert snap.degraded_reads() == res.degraded_reads
    by = snap.reads_by_class()
    assert by["from_sym"] + by["parity_decode"] + by["degraded_fault"] \
        == res.degraded_reads
    assert snap.parked_writes() == res.parked_writes
    assert int(snap.lat_hist_read.sum()) == res.served_reads
    assert int(snap.lat_hist_write.sum()) == res.served_writes
    d = snap.as_dict()
    assert d["derived"]["served_reads"] == res.served_reads
    assert "rq_core" not in d


def test_stall_planes_under_queue_pressure():
    """Queues of 2 and all traffic on banks 0 and 1: the stall storm is
    attributed exactly, to those banks only, and every leaf equals
    JAX's."""
    js, ts = _systems(n_cores=8, queue_depth=2)
    rng = np.random.default_rng(5)
    tr = rand_trace(rng, 8, 24, 8, 64, write_frac=0.3)
    tr = tr._replace(bank=(tr.bank % 2).astype(tr.bank.dtype),
                     valid=np.ones_like(np.asarray(tr.valid)))
    jst, _ = js._run(js.init(), tr, 128)
    tst, _ = ts._run(ts.init(), _jtrace_to_port(tr), 128)
    assert_states_equal(jst, tst, "pressure")
    res, snap = ts.summarize(tst), planes.snapshot(tst)
    assert res.stall_cycles > 0
    assert snap.stall_total() == res.stall_cycles
    assert int(snap.stall_cause[2:].sum()) == 0


@pytest.mark.parametrize("scheme", ["scheme_i", "scheme_iii"])
def test_planes_of_a_disagreeing_batch_match_jax_and_oracle(scheme):
    """Three points lock-step on the port's point axis, whose
    read/write choices disagree on some cycles (both branches then run on
    masked candidates): each point's every leaf, planes included, equals
    JAX's ``run`` of it, and its planes the oracle's ``OracleTelemetry``
    (write fraction 0.45, as in JAX's conformance test)."""
    js, ts = _systems(scheme)
    om = oracle_twin(js)
    traces = [_trace(seed=s) for s in (11, 12, 13)]
    st = ts.init_batch(state.batch_tunables([ts.tunables] * 3, CPU))
    tr_b = system.Trace(*(torch.stack(xs) for xs in zip(
        *(_jtrace_to_port(t) for t in traces))))
    tn_b = state.batch_tunables([ts.tunables] * 3, CPU)
    masked = []
    reads = ts._do_reads

    def spy(m, rs_a, active=None, **kw):
        masked.append(active is not None)
        return reads(m, rs_a, active, **kw)

    ts._do_reads = spy
    try:
        for _ in range(N_CYCLES):
            st, _ = ts.cycle_batch(st, tr_b, tn_b)
    finally:
        del ts._do_reads
    assert any(masked), "the points never disagreed"
    for k, tr in enumerate(traces):
        jst, _ = js._run(js.init(), tr, N_CYCLES)
        ost = om.run(tr, N_CYCLES)
        assert_state_matches_oracle(jst, ost, f"{scheme} jax [{k}]")
        pt = state.point_of(st, k)
        assert_states_equal(jst, pt, f"{scheme} [{k}]")
        assert_planes_match_oracle(pt.mem.tele, ost, f"{scheme} [{k}]")


def test_lat_bin_matches_jax_and_oracle():
    """The threshold count equals JAX's and the oracle's ``bit_length``
    binning over 0 .. 2**16 and beyond, to INT32_MAX."""
    lats = np.concatenate([np.arange(0, 1 << 16),
                           [1 << 16, (1 << 16) + 1, 1 << 20, 1 << 30,
                            np.iinfo(np.int32).max]]).astype(np.int32)
    got = planes.lat_bin(torch.from_numpy(lats)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jplanes.lat_bin(lats)))
    np.testing.assert_array_equal(got, [oracle_lat_bin(int(v))
                                        for v in lats])


# ------------------------------------------------------- 3. the sweep layer
def test_run_points_snapshots_match_jax():
    """``run_points(collect_telemetry=True)`` returns JAX's results and
    each point's snapshot plane for plane (None for a telemetry-off
    point), across batches (``tests/test_obs.py``'s points on 4 cores x
    16)."""
    base = dict(n_rows=64, length=16, n_cores=4, alpha=0.25, r=0.125)
    jpts = [JPoint(**base), JPoint(**base, telemetry=True, seed=1),
            JPoint(**base, telemetry=True, seed=2, write_frac=0.6),
            JPoint(**{**base, "alpha": 1.0}, telemetry=True,
                   scheme="uncoded")]
    tpts = [SweepPoint(**{f: getattr(p, f)
                          for f in p.__dataclass_fields__}) for p in jpts]
    # JAX's telemetry-on points only (its off point would be one more
    # compile of the same engine the sweep tests hold already)
    want, jsnaps = jrun_points(jpts[1:], collect_telemetry=True)
    got, snaps, states = run_points(tpts, device=CPU,
                                    collect_telemetry=True,
                                    return_state=True)
    assert got[1:] == want
    assert got[0] == run_points(tpts[:1], device=CPU)[0]
    for k, (g, w) in enumerate(zip(snaps[1:], jsnaps), 1):
        assert_snapshots_equal(g, w, f"point {k}")
    assert snaps[0] is None and states[0].mem.tele is None
    assert planes.snapshot(states[1]).as_dict() == snaps[1].as_dict()


def test_stream_replay_windows_match_jax():
    """With telemetry on each window carries its histogram delta (JAX's
    third element): ``stream_replay`` equals JAX's at chunk 8, windows
    included, and the deltas add up to the final planes."""
    js, ts = _systems()
    tr = _trace(length=24)
    want = jstream_replay(js, tr, chunk_len=8)
    got, st = stream_replay(ts, _jtrace_to_port(tr), chunk_len=8,
                            return_state=True)
    assert got == want
    assert all(len(w) == 3 for w in got.window_read_latency)
    snap = planes.snapshot(st)
    np.testing.assert_array_equal(
        np.sum([w[2] for w in got.window_read_latency], 0),
        snap.lat_hist_read)
    np.testing.assert_array_equal(
        np.sum([w[2] for w in got.window_write_latency], 0),
        snap.lat_hist_write)


def test_stream_replay_points_windows_match_jax(tmp_path):
    """``stream_replay_points`` of telemetry-on points at chunk 4 equals
    JAX's, histogram windows included; a pass killed after a checkpoint
    resumes to the same results (the planes are saved and restored). The
    geometry is ``tests/test_torch_stream_points.py``'s, on an alpha
    axis."""
    base = dict(scheme="scheme_i", r=0.125, n_rows=32, n_cores=3,
                n_banks=8, length=10, select_period=16, telemetry=True)
    jpts = [JPoint(**base, alpha=a, seed=s)
            for a, s in ((0.25, 0), (0.25, 1), (0.5, 2))]
    tpts = [SweepPoint(**base, alpha=p.alpha, seed=p.seed) for p in jpts]
    want = jstream_points(jpts, [jbuild_trace(p) for p in jpts],
                          chunk_len=4)
    ttr = [build_trace(p, device=CPU) for p in tpts]
    got = stream_replay_points(tpts, ttr, chunk_len=4, device=CPU)
    assert got == want
    assert all(len(w) == 3 for g in got for w in g.window_write_latency)
    kw = dict(chunk_len=4, device=CPU, checkpoint_dir=str(tmp_path),
              checkpoint_every=2)
    cut = stream_replay_points(tpts, ttr, max_cycles=4, **kw)
    assert cut != got
    assert stream_replay_points(tpts, ttr, resume=True, **kw) == got


def test_convert_carries_the_tele_leaf():
    """A JAX telemetry-on state mid-run converts to the port (int64
    counters) and back (uint32), one point's and a batch's, and the port
    runs on from it as JAX does."""
    js, ts = _systems()
    tr = _trace(seed=3)
    jst, _ = js._run(js.init(), tr, 30)
    host = jax.device_get(jst)
    tst = convert.sim_state_from_numpy(host, CPU)
    assert tst.mem.tele.stall_cause.dtype == torch.int64
    assert tst.mem.tele.rq_core.dtype == torch.int32
    assert_states_equal(jst, tst, "converted")
    pair = jax.tree.map(lambda x: np.stack([x, x]), host)
    back = convert.sim_state_to_numpy(convert.sim_state_from_numpy(pair,
                                                                   CPU))
    for name, a, b in zip(planes.Telemetry._fields, pair.mem.tele,
                          back.mem.tele):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    jst2, _ = js._run(jst, tr, 40)
    tst2, _ = ts._run(tst, _jtrace_to_port(tr), 40)
    assert_states_equal(jst2, tst2, "ran on")


# ------------------------------------------------ 4. reports and timeline
def _blob(path):
    with open(path) as f:
        blob = json.load(f)
    blob.pop("manifest")
    return blob


@pytest.mark.parametrize("availability", [False, True])
def test_reports_match_jax(tmp_path, availability, capsys):
    """The port's report CLI at ``--smoke`` on the CPU writes JAX's numbers:
    the JSON twin equal but for the manifest, the markdown equal below its
    header line (the planes checked against the aggregates on both
    sides)."""
    fn = (jreport.availability_report if availability
          else jreport.stall_report)
    want = fn("paper_fig18", out_dir=str(tmp_path / "jax"), smoke=True)
    argv = ["--suite", "paper_fig18", "--smoke", "--device", CPU,
            "--out-dir", str(tmp_path / "port")]
    assert report.main(argv + (["--availability"] if availability
                               else [])) == 0
    assert "planes == aggregates verified" in capsys.readouterr().out
    stem = ("availability_paper_fig18" if availability
            else "stall_report_paper_fig18")
    got_json = tmp_path / "port" / f"{stem}.json"
    assert _blob(got_json) == _blob(want["json_path"])
    with open(tmp_path / "port" / f"{stem}.md") as f:
        got_md = f.read().splitlines()
    with open(want["md_path"]) as f:
        want_md = f.read().splitlines()
    assert got_md[0] == want_md[0] and got_md[3:] == want_md[3:]
    if availability:
        blob = _blob(got_json)
        assert all(p["dead_bank_cycles"] > 0 for p in blob["points"])


def test_report_refuses_disagreeing_planes():
    """A snapshot whose planes disagree with the aggregates is refused
    with JAX's message."""
    _, ts = _systems()
    st, _ = ts._run(ts.init(), _jtrace_to_port(_trace()), N_CYCLES)
    res, snap = ts.summarize(st), planes.snapshot(st)
    pt = SweepPoint(alpha=0.25, r=0.125)
    report._check_against_result(pt, res, snap)
    snap.stall_cause[0, 0] += 1
    with pytest.raises(AssertionError, match="stall_cycles"):
        report._check_against_result(pt, res, snap)


def test_timeline_matches_jax(tmp_path):
    """``record_timeline``'s events equal JAX's for the same trace (4
    cores x 16, chunk 8); the exported trace loads, with every span closed
    and monotonic time; the CLI at ``--smoke`` writes JAX's events."""
    js, ts = _systems(telemetry=False)
    tr = _trace(seed=3, length=16)
    want = jtimeline.record_timeline(js, tr, chunk_len=8, max_cycles=256)
    got = timeline.record_timeline(ts, _jtrace_to_port(tr), chunk_len=8,
                                   max_cycles=256)
    assert got == want
    assert {e["ph"] for e in got} >= {"M", "C", "i", "B", "E"}
    path = timeline.export_chrome_trace(got, str(tmp_path / "tl.json"),
                                        manifest={"run": "test"})
    with open(path) as f:
        blob = json.load(f)
    ts_ = [e["ts"] for e in blob["traceEvents"] if "ts" in e]
    assert ts_ == sorted(ts_) and blob["otherData"]["manifest"]
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    assert jtimeline.main(["--smoke", "--out", str(jpath)]) == 0
    assert timeline.main(["--smoke", "--device", CPU, "--out",
                          str(tpath)]) == 0
    with open(jpath) as f, open(tpath) as g:
        assert json.load(g)["traceEvents"] == json.load(f)["traceEvents"]
