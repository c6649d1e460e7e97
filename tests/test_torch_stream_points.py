"""The port's batched streamed replay (``repro_torch.traces.
stream_replay_points``) and its checkpointed resume (``repro_torch.
checkpoint``) on the CPU against the JAX package, bit for bit: each point
equals JAX's ``stream_replay_points`` (windows included) and the port's
``run_points`` on the materialized traces (windows aside), for a uniform
batch, an α axis and a traced r axis at several chunk lengths; the
one-signature error; a replay killed mid-stream resumes to the
uninterrupted result (mirrors ``tests/test_traces.py:791-830``).

The geometry is ``tests/test_traces.py``'s (32 rows, 3 cores, length 10,
scheme_i, alpha 0.25, r 0.125, select period 16)."""
import importlib
import os

import numpy as np
import pytest
import torch

from repro import traces as jtraces
from repro.sweep import workloads as jwork
from repro_torch import checkpoint, traces
from repro_torch.sweep import engine, workloads

jgrid = importlib.import_module("repro.sweep.grid")
tgrid = importlib.import_module("repro_torch.sweep.grid")
CPU = "cpu"
JBASE = jgrid.SweepPoint(scheme="scheme_i", alpha=0.25, r=0.125, n_rows=32,
                         n_cores=3, n_banks=8, length=10, select_period=16)


def _tpt(jpt):
    return tgrid.SweepPoint(**{k: getattr(jpt, k) for k in
                               jpt.__dataclass_fields__})


BATCHES = {
    "seeds": jgrid.grid(JBASE, seed=(0, 1, 2)),
    "alpha_axis": jgrid.grid(JBASE, alpha=(0.125, 0.25, 0.5)),
    "r_axis": jgrid.grid(JBASE, alpha=(0.25, 0.5), r=(0.125, 0.25)),
}


@pytest.mark.parametrize("chunk_len", [3, 7])
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_stream_replay_points_matches_jax_and_run_points(name, chunk_len):
    jpts = BATCHES[name]
    tpts = [_tpt(p) for p in jpts]
    jtr = [jwork.build_trace(p) for p in jpts]
    ttr = [workloads.build_trace(p, device=CPU) for p in tpts]
    got = traces.stream_replay_points(tpts, ttr, chunk_len=chunk_len,
                                      device=CPU)
    assert got == jtraces.stream_replay_points(jpts, jtr,
                                               chunk_len=chunk_len)
    single = engine.run_points(tpts, ttr, device=CPU)
    assert [traces.strip_windows(r) for r in got] == single
    assert all(len(r.window_read_latency) > 1 for r in got)


def test_stream_replay_points_takes_lazy_sources_and_priors():
    """Chunk iterators of numpy arrays (what ``stream_file`` yields) and
    region priors, against JAX's replay of the same."""
    jpts = jgrid.grid(JBASE, seed=(3, 4))
    tpts = [_tpt(p) for p in jpts]
    jtr = [jwork.build_trace(p) for p in jpts]
    chunks = [traces.chunk_iter(workloads.build_trace(p, device=CPU), 4)
              for p in tpts]
    pri = [np.array([2, 1]), None]
    got = traces.stream_replay_points(tpts, chunks, chunk_len=5,
                                      region_priors=pri, device=CPU)
    assert got == jtraces.stream_replay_points(
        jpts, [jtraces.chunk_iter(t, 4) for t in jtr], chunk_len=5,
        region_priors=pri)
    single = engine.run_points(tpts, [workloads.build_trace(p, device=CPU)
                                      for p in tpts], region_priors=pri,
                               device=CPU)
    assert [traces.strip_windows(r) for r in got] == single


def test_stream_replay_points_rejects_mixed_signatures():
    jpts = [JBASE, JBASE.replace(n_rows=64)]
    tpts = [_tpt(p) for p in jpts]
    with pytest.raises(ValueError) as je:
        jtraces.stream_replay_points(jpts, [jwork.build_trace(p)
                                            for p in jpts])
    with pytest.raises(ValueError) as te:
        traces.stream_replay_points(tpts, [workloads.build_trace(
            p, device=CPU) for p in tpts], device=CPU)
    assert str(te.value) == str(je.value).replace("repro.sweep",
                                                  "repro_torch.sweep")
    with pytest.raises(ValueError, match="align"):
        traces.stream_replay_points(tpts, [], device=CPU)


def test_stream_replay_points_on_cycle_sees_every_cycle():
    """``on_cycle(before, after, out)`` sees each batched cycle of every
    chunk once, in order, with the whole batch's states; the hook changes
    no result."""
    tpts = [_tpt(JBASE.replace(seed=s)) for s in (0, 1, 2)]
    ttr = [workloads.build_trace(p, device=CPU) for p in tpts]
    seen = []

    def hook(before, after, out):
        assert before.mem.cycle.shape == (len(tpts),)
        seen.append(before.mem.cycle.tolist())
        assert after.mem.cycle.tolist() == [c + 1 for c in seen[-1]]

    got = traces.stream_replay_points(tpts, ttr, chunk_len=4, device=CPU,
                                      on_cycle=hook)
    assert got == traces.stream_replay_points(tpts, ttr, chunk_len=4,
                                              device=CPU)
    assert seen == [[c] * len(tpts) for c in range(len(seen))]
    assert len(seen) >= max(r.cycles for r in got)
    # JAX's positional call: shard sixth (one device: the same run)
    assert traces.stream_replay_points(tpts, ttr, 4, None, None, True,
                                       device=CPU) == got


def test_stream_replay_points_kill_and_resume(tmp_path):
    """A replay killed mid-stream resumes from its last committed
    checkpoint to the uninterrupted run's results, window series included
    (and those equal JAX's)."""
    jpts = [JBASE.replace(seed=s) for s in (0, 1)]
    tpts = [_tpt(p) for p in jpts]
    ttr = [workloads.build_trace(p, device=CPU) for p in tpts]
    ckdir = str(tmp_path / "ck")
    want = traces.stream_replay_points(tpts, ttr, chunk_len=4, device=CPU)
    assert want == jtraces.stream_replay_points(
        jpts, [jwork.build_trace(p) for p in jpts], chunk_len=4)
    # "kill": stop mid-stream after checkpoints have committed
    cut = traces.stream_replay_points(tpts, ttr, chunk_len=4, device=CPU,
                                      checkpoint_dir=ckdir,
                                      checkpoint_every=1, max_cycles=8)
    assert cut != want
    assert checkpoint.latest_step(ckdir) is not None
    got = traces.stream_replay_points(tpts, ttr, chunk_len=4, device=CPU,
                                      checkpoint_dir=ckdir,
                                      checkpoint_every=1, resume=True)
    assert got == want
    with pytest.raises(ValueError, match="resume"):
        traces.stream_replay_points(tpts, ttr, chunk_len=4, resume=True,
                                    device=CPU)


def test_checkpoint_commits_atomically(tmp_path):
    """A step is readable only once committed: a staging directory left by
    a killed writer, or a step without its manifest, is not a step; a
    restored tree keeps its structure, dtypes and devices; the manager
    keeps the newest steps and raises what its writer raised."""
    d = str(tmp_path)
    tree = {"state": (torch.arange(6, dtype=torch.int32).view(2, 3),
                      torch.tensor([True, False]), None),
            "pos": np.arange(4, dtype=np.int64)}
    checkpoint.save(3, tree, d)
    os.makedirs(os.path.join(d, "step_000000009.tmp123"))
    os.makedirs(os.path.join(d, "step_000000007"))       # no manifest
    assert checkpoint.latest_step(d) == 3
    back = checkpoint.restore(d, tree)
    assert back["state"][2] is None
    for a, b in zip(back["state"][:2], tree["state"][:2]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert back["pos"].dtype == np.int64 and (back["pos"] == tree["pos"]).all()
    mgr = checkpoint.CheckpointManager(d, keep=2)
    for step in (4, 5, 6):
        mgr.save_async(step, tree)
    mgr.wait()
    assert checkpoint.latest_step(d) == 6
    assert not os.path.exists(os.path.join(d, "step_000000004"))
    with pytest.raises(TypeError):
        mgr.save_async(8, {"bad": object()})
    (tmp_path / "a_file").write_text("")
    bad = checkpoint.CheckpointManager(str(tmp_path / "a_file"))
    bad.save_async(1, tree)
    with pytest.raises(OSError):
        bad.wait()
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), tree)
