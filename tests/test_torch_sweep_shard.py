"""The sweep's point axis sharded (``shard=True``, JAX's default) on the
CPU: ``repro_torch.launch.mesh.make_sweep_mesh`` is replaced to lay 4 (or
3) shards on the CPU, as JAX's own sharding test forces 4 host devices.
A padded batch split over the shards equals the port's unsharded run
(results, telemetry snapshots, every state leaf, a fault leaf in the
batch) and JAX's ``run_points(shard=False)`` (results, snapshots), JAX's
positional call runs, and
``stream_replay_points`` over 4 shards equals the unsharded replay and
JAX's, windows included, and resumes a checkpoint written at 4 shards at
1 and at 3 (mirrors ``tests/test_sweep.py::
test_padded_sharding_multidevice_subprocess`` and ``tests/test_traces.py::
test_stream_points_padded_sharding_multidevice_subprocess``, which fail
in a single-device container, so the port is held against JAX's
unsharded runs).

The geometry is ``tests/test_torch_stream_points.py``'s (32 rows, 3 cores,
length 10, scheme_i, r 0.125, select period 16), with telemetry on and a
bank fault in every point's plan."""
import dataclasses
import importlib

import jax
import pytest
import torch
from test_torch_obs import assert_snapshots_equal

from repro.sweep import run_points as jrun_points
from repro.sweep import workloads as jwork
from repro.traces.stream import stream_replay_points as jstream_points
from repro_torch.core.state import point_of
from repro_torch.launch import mesh
from repro_torch.sweep import engine, partition, run_points, workloads
from repro_torch.traces import stream_replay_points, strip_windows

jgrid = importlib.import_module("repro.sweep.grid")
tgrid = importlib.import_module("repro_torch.sweep.grid")
CPU = "cpu"
JBASE = jgrid.SweepPoint(scheme="scheme_i", alpha=0.25, r=0.125, n_rows=32,
                         n_cores=3, n_banks=8, length=10, select_period=16,
                         telemetry=True)
# one plan a point: a dead bank, a late failure, a stutter
PLANS = ((("bank", 0, 0),), (("bank", 3, 8, 40),), (("stutter", 2, 3),))


def _tpt(jpt) -> tgrid.SweepPoint:
    return tgrid.SweepPoint(**{f.name: getattr(jpt, f.name)
                              for f in dataclasses.fields(jpt)})


def _points(n: int):
    """``n`` points of one batch: seeds and an alpha axis, each with its
    own fault plan."""
    jpts = [JBASE.replace(seed=k, alpha=(0.25, 0.5)[k % 2],
                          faults=PLANS[k % len(PLANS)]) for k in range(n)]
    return jpts, [_tpt(p) for p in jpts]


@pytest.fixture(autouse=True, scope="module")
def _one_thread_fast_compiles():
    """One torch thread, and JAX's programs compiled at XLA's backend
    optimization level 0 (integer arithmetic: the results do not depend
    on it), as in tests/test_torch_faults.py; restored afterwards."""
    saved = (jax.config.read("jax_disable_most_optimizations"),
             torch.get_num_threads())
    jax.config.update("jax_disable_most_optimizations", True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_disable_most_optimizations", saved[0])
    torch.set_num_threads(saved[1])


def _lay(monkeypatch, n: int) -> None:
    """Lay the point axis over ``n`` CPU shards."""
    monkeypatch.setattr(mesh, "make_sweep_mesh",
                        lambda n_devices=0, *, device=None:
                        [torch.device(CPU)] * n)


def test_padded_batch_over_four_shards_equals_unsharded_and_jax(
        monkeypatch):
    """6 points over 4 shards (2 rows of padding, one shard all copies of
    the last point): results, snapshots and every final state leaf equal
    the unsharded port's and JAX's unsharded run's; ``on_cycle`` sees the
    unpadded batch every cycle; JAX's positional call runs."""
    jpts, tpts = _points(6)
    assert len(partition(tpts)) == 1
    want, wsnaps, wstates = run_points(tpts, None, False, None, True,
                                       device=CPU, return_state=True)
    seen = []

    def hook(batch, before, after, out):
        assert before.mem.cycle.shape == (6,) == out.r_served.shape[:1]
        seen.append(after.mem.cycle.tolist())

    _lay(monkeypatch, 4)
    assert engine.shard_devices(torch.device(CPU), True) == [
        torch.device(CPU)] * 4
    assert engine._pad_points(6, 4) == 2
    got, snaps, states = run_points(tpts, None, True, None, True,
                                    device=CPU, return_state=True,
                                    on_cycle=hook)
    assert got == want
    for k, (g, w) in enumerate(zip(snaps, wsnaps)):
        assert_snapshots_equal(g, w, f"point {k}")
    for k, (g, w) in enumerate(zip(states, wstates)):
        assert_same_state(g, w, f"point {k}")
    n = int(states[0].mem.cycle)
    assert len(seen) == n and seen[-1] == [n] * 6
    jwant, jsnaps = jrun_points(jpts, None, False, None, True)
    assert got == jwant
    for k, (g, w) in enumerate(zip(snaps, jsnaps)):
        assert_snapshots_equal(g, w, f"point {k} vs JAX")
    # JAX's positional call, and run_batch returning the gathered state
    assert run_points(tpts, None, True, device=CPU) == want
    res, st = engine.run_batch(partition(tpts)[0], None, True, device=CPU,
                               return_state=True)
    assert res == want and st.done_cycle.shape == (6,)
    for k, w in enumerate(wstates):
        assert_same_state(point_of(st, k), w, f"run_batch point {k}")


def assert_same_state(a, b, label=""):
    """Two of the port's SimStates leaf for leaf (tele and fault too)."""
    for name in ("core_ptr", "done_cycle"):
        assert torch.equal(getattr(a, name), getattr(b, name)), label
    for name, x in a.mem._asdict().items():
        y = getattr(b.mem, name)
        if x is None or isinstance(x, tuple):
            assert (x is None) == (y is None), f"{label}: {name}"
            for f, u, v in zip(x._fields if x else (), x or (), y or ()):
                assert torch.equal(u, v), f"{label}: {name}.{f}"
        else:
            assert torch.equal(x, y), f"{label}: {name}"


def test_shard_points_of_several_batches(monkeypatch):
    """A sweep of two batches over 3 shards (padding 2 and 1): each point
    in ``points`` order equals the unsharded run, states included."""
    _, a = _points(4)
    b = [p.replace(telemetry=False, seed=10 + k)
         for k, p in enumerate(a[:2])]
    pts = [a[0], b[0], a[1], a[2], b[1], a[3]]
    assert len(partition(pts)) == 2
    want, wstates = run_points(pts, None, False, device=CPU,
                               return_state=True)
    _lay(monkeypatch, 3)
    got, states = run_points(pts, None, True, device=CPU, return_state=True)
    assert got == want
    for k, (g, w) in enumerate(zip(states, wstates)):
        assert_same_state(g, w, f"point {k}")


def test_stream_points_over_four_shards_resume_at_one_and_three(
        monkeypatch, tmp_path):
    """``stream_replay_points(points, sources, 4, None, None, True)`` over
    4 shards (5 points: 3 rows of padding) equals the unsharded replay
    and JAX's, histogram windows included, and ``run_points`` windows
    aside; a pass killed at 4 shards after a checkpoint resumes at 1 and
    at 3 shards to the same results."""
    jpts, tpts = _points(5)
    ttr = [workloads.build_trace(p, device=CPU) for p in tpts]
    want = stream_replay_points(tpts, ttr, 4, None, None, False, device=CPU)
    assert want == jstream_points(jpts, [jwork.build_trace(p)
                                         for p in jpts], 4, None, None,
                                  False)
    assert all(len(w) == 3 for r in want for w in r.window_read_latency)
    _lay(monkeypatch, 4)
    got = stream_replay_points(tpts, ttr, 4, None, None, True, device=CPU)
    assert got == want
    assert [strip_windows(r) for r in got] == run_points(tpts, None, True,
                                                         device=CPU)
    for n_shards in (1, 3):
        ckdir = str(tmp_path / f"ck{n_shards}")
        _lay(monkeypatch, 4)
        cut = stream_replay_points(tpts, ttr, 4, None, 4, True, ckdir, 1,
                                   device=CPU)
        assert cut != want
        _lay(monkeypatch, n_shards)
        assert stream_replay_points(tpts, ttr, 4, None, None, True, ckdir,
                                    1, True, device=CPU) == want


def test_one_device_pads_and_splits_nothing():
    """With one device ``shard=True`` is the unsharded run itself: the
    helpers return their input, and results and states are equal bit for
    bit."""
    _, tpts = _points(3)
    tree = (torch.arange(6).view(3, 2), None)
    assert engine._pad_points(3, 1) == 0
    assert engine._replicate_tail(tree, 0) is tree
    assert engine._maybe_shard(tree, [torch.device(CPU)]) == [tree]
    assert engine._gather([tree], 3, torch.device(CPU)) is tree
    padded = engine._replicate_tail(tree, 2)
    assert padded[0].tolist()[-3:] == [[4, 5]] * 3 and padded[1] is None
    res_t, st_t = run_points(tpts, None, True, device=CPU, return_state=True)
    res_f, st_f = run_points(tpts, None, False, device=CPU,
                             return_state=True)
    assert res_t == res_f
    for k, (a, b) in enumerate(zip(st_t, st_f)):
        assert_same_state(a, b, f"point {k}")
