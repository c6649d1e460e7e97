"""Streaming trace replay: arbitrarily long traces, fixed device footprint;
port of ``repro/traces/stream.py``.

``stream_replay`` threads an explicit ``SimState`` through successive
``CodedMemorySystem.run_chunk`` calls. Each step stages a fixed-shape
``(n_cores, chunk_len)`` buffer of each core's next requests (the window is
ragged across cores) and runs cycles until some core needs data beyond the
buffer, the system quiesces, or the per-chunk ``drain_bound`` budget runs
out. The starvation exit falls between cycles, so every cycle sees the
requests the single-shot program would: the replay equals ``run()`` on the
whole trace, for any chunk split, and its quiescent exit skips the drained
tail a single-shot run spends up to ``drain_bound``.

``stream_replay_points`` composes the chunk axis with the sweep engine's
point axis: a shape-compatible batch of points, each with its own trace
source, replays chunked lock-step (``run_chunk_batch``), each point with
its own per-core staging windows, optionally checkpointed
(``repro_torch.checkpoint``) and resumed, its point axis sharded over the
visible cards as the sweep engine's is.

Each ``run_chunk`` return is a window boundary: the served-count and
latency-sum differences between boundaries give the per-window read and
write latency series in ``SimResult.window_read_latency`` /
``window_write_latency``. The port's latency sums are native int64, so the
differences are taken directly, and each window's averages come from the
same integers as JAX's. With ``MemParams.telemetry`` each window entry
carries a third element, the window's delta of the latency histogram
(``repro_torch.obs.planes``, log2 bins); without it the entries keep
their 2-tuple shape.
"""
from __future__ import annotations

import json
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.state import TunableParams
from repro_torch.core.system import (CodedMemorySystem, SimResult, SimState,
                                     drain_bound, quiescent,
                                     run_chunk_shards, summarize_batch)
from repro_torch.kernels.common import resolve_device
from repro_torch.obs.planes import HIST_BINS
from repro_torch.traces.source import as_source, stage_batch

DEFAULT_CHUNK_LEN = 256


def strip_windows(res: SimResult) -> SimResult:
    """Drop the per-window series (for comparing streamed vs single-shot)."""
    return res._replace(window_read_latency=(), window_write_latency=())


def chunk_bound(system: CodedMemorySystem, chunk_len: int) -> int:
    """Per-chunk cycle budget: ``drain_bound`` with the carried queue
    backlog (every read and write queue slot may still hold a request of
    the previous chunk)."""
    backlog = 2 * system.p.n_data * system.p.queue_depth
    return drain_bound(system.n_cores, chunk_len, backlog=backlog)


def _window_stats(prev, now) -> Tuple[tuple, tuple]:
    """((n_reads, avg_read_lat[, hist]), (n_writes, avg_write_lat[, hist]))
    of one window, from two ``_snapshot`` readings as ints; ``hist``, the
    window's delta of the latency histogram, only with telemetry on."""
    dr = now[0] - prev[0]
    dw = now[1] - prev[1]
    wr: tuple = (dr, (now[2] - prev[2]) / max(dr, 1))
    ww: tuple = (dw, (now[3] - prev[3]) / max(dw, 1))
    if len(now) > 4:
        hb = HIST_BINS
        delta = [a - b for a, b in zip(now[4:], prev[4:])]
        wr += (tuple(delta[:hb]),)
        ww += (tuple(delta[hb:]),)
    return wr, ww


def _snapshot(st: SimState) -> torch.Tensor:
    """(served_reads, served_writes, read_latency_sum, write_latency_sum)
    and, with telemetry on, the read and write latency histograms, as one
    int64 tensor: (4[+ 2 HIST_BINS],) for one point, (B, ...) for a
    batch."""
    m = st.mem
    cols = torch.stack([m.served_reads.long(), m.served_writes.long(),
                        m.read_latency_sum, m.write_latency_sum], -1)
    if m.tele is None:
        return cols
    return torch.cat([cols, m.tele.lat_hist_read, m.tele.lat_hist_write],
                     -1)


def stream_replay(system: CodedMemorySystem, source,
                  chunk_len: int = DEFAULT_CHUNK_LEN,
                  tn: Optional[TunableParams] = None,
                  st: Optional[SimState] = None,
                  region_priors=None,
                  max_cycles: Optional[int] = None,
                  return_state: bool = False,
                  on_cycle: Optional[Callable] = None):
    """Replay a (possibly longer-than-memory) trace through the cycle
    engine on ``system``'s device.

    ``source`` is anything ``as_source`` takes: a ``Trace``, an iterable of
    ``Trace`` chunks, or a ``TraceSource``. The result equals single-shot
    ``run()`` on the whole trace, window series aside.

    ``max_cycles`` caps the simulated cycles (the per-chunk budget bounds
    each step); a workload that cannot complete stops once a whole chunk
    budget passes with no request progress, with ``completed=False``, as
    an exhausted single-shot bound reports. Each step reads its exit
    state to the host once.

    As ``repro_torch.sim.ramulator.simulate`` does, ``return_state`` also
    returns the final ``SimState`` (``(result, state)``), and
    ``on_cycle(before, after, out)`` sees every cycle of every chunk."""
    src = as_source(source)
    tn = tn if tn is not None else system.tunables
    if st is None:
        st = system.init(tn, region_priors=region_priors)
    if src.n_cores is not None and src.n_cores != system.n_cores:
        raise ValueError(f"source has {src.n_cores} cores, "
                         f"system has {system.n_cores}")
    pos = np.zeros(system.n_cores, np.int64)
    bound = chunk_bound(system, chunk_len)
    win_r: List[tuple] = []
    win_w: List[tuple] = []
    *prev, prev_cycle = torch.cat([_snapshot(st),
                                   st.mem.cycle.long().view(1)]).tolist()
    nc = system.n_cores
    while True:
        chunk, stream_end = src.stage(pos, chunk_len, system.device)
        st = st._replace(core_ptr=torch.zeros_like(st.core_ptr))
        st = system.run_chunk(st, chunk, stream_end, bound, tn, on_cycle)
        host = torch.cat([st.core_ptr.long(), quiescent(st).long().view(1),
                          st.mem.cycle.long().view(1), _snapshot(st)]).tolist()
        moved = np.asarray(host[:nc], np.int64)
        quiet, cyc, snap = host[nc], host[nc + 1], host[nc + 2:]
        wr, ww = _window_stats(prev, snap)
        win_r.append(wr)
        win_w.append(ww)
        prev = snap
        pos += moved
        if src.exhausted(pos) and quiet:
            break
        if not moved.any() and cyc - prev_cycle >= bound:
            break                       # budget spent with zero progress:
                                        # the workload cannot complete
        if max_cycles is not None and cyc >= max_cycles:
            break
        prev_cycle = cyc
    res = system.summarize(st)._replace(window_read_latency=tuple(win_r),
                                        window_write_latency=tuple(win_w))
    return (res, st) if return_state else res


# -------------------------------------------------------- checkpointed carry
# The whole replay carry is three leaves: the batched SimState, the per-core
# stream positions, and the accumulated window series (JSON bytes: ragged
# python tuples are no fixed-shape leaf). ``prev``/``prev_cycle`` are not
# saved: at a chunk boundary they are ``_snapshot`` and ``mem.cycle`` of
# the carried state, so resume re-derives them.

def _wins_blob(win_r, win_w) -> np.ndarray:
    return np.frombuffer(json.dumps([win_r, win_w]).encode("utf-8"),
                         np.uint8).copy()


def _wins_unblob(arr) -> Tuple[List[List[tuple]], List[List[tuple]]]:
    def tup(x):
        return tuple(tup(e) for e in x) if isinstance(x, list) else x

    wr, ww = json.loads(bytes(np.asarray(arr, np.uint8).tobytes()).decode())
    return ([[tup(w) for w in pt] for pt in wr],
            [[tup(w) for w in pt] for pt in ww])


def stream_replay_points(points: Sequence, sources: Sequence,
                         chunk_len: int = DEFAULT_CHUNK_LEN,
                         region_priors: Optional[Sequence] = None,
                         max_cycles: Optional[int] = None,
                         shard: bool = True,
                         checkpoint_dir: Optional[str] = None,
                         checkpoint_every: int = 0,
                         resume: bool = False,
                         *, device=None,
                         on_cycle: Optional[Callable] = None
                         ) -> List[SimResult]:
    """Chunked batched replay: one shape-compatible batch of sweep points,
    each with its own (arbitrarily long) trace source, lock-step on the
    core's point axis, on ``device`` (the card unless named).

    ``points`` must share a single static signature (one
    ``repro_torch.sweep.partition`` batch; the caller splits mixed
    sweeps); ``sources`` align 1:1 (anything ``as_source`` takes). Each
    point's result equals ``repro_torch.sweep.run_points`` on the
    materialized traces, window series aside, and JAX's
    ``stream_replay_points`` windows included. A chunk step leaves its
    loop when any point of any shard starves (its window restages and
    every point goes on) or every point is quiescent.

    With ``shard`` (JAX's default) and more than one device from
    ``repro_torch.launch.mesh.make_sweep_mesh``, the point axis is padded
    to a multiple of the device count with copies of the last point (its
    state, tunables and every chunk's staged buffer and ``stream_end``)
    and split into one shard per device, as ``run_batch`` does: a copy
    starves and quiesces exactly when its original does, so windows,
    restaging and checkpoints equal the unsharded replay's.

    With ``checkpoint_dir`` and ``checkpoint_every=N``, the replay carry
    (batched state, stream positions, window series) is checkpointed
    atomically every N chunks (an asynchronous writer; a killed run never
    leaves a readable half-checkpoint). The saved state is the unpadded
    batch gathered onto the first shard's device, so a run resumes at any
    shard count. ``resume=True`` restores the latest committed checkpoint
    and continues: each point's final result equals the uninterrupted
    run's, windows included. The caller supplies equivalent ``sources``
    again; a lazy source only replays forward to the restored positions.
    ``on_cycle(before, after, out)`` sees the batched (gathered, unpadded)
    states of every cycle of every chunk."""
    from repro_torch.sweep.engine import (_gather, _maybe_shard, _pad_points,
                                          _replicate_tail, _stack_faults,
                                          _stack_priors, gathered_hook,
                                          mixed_geometry, shard_devices,
                                          stack_tunables, system_for)
    from repro_torch.sweep.grid import batch_geometry_alloc, static_signature

    if len(sources) != len(points):
        raise ValueError("sources must align 1:1 with points")
    sigs = {static_signature(pt) for pt in points}
    if len(sigs) > 1:
        raise ValueError(
            f"stream_replay_points needs one shape-compatible batch, got "
            f"{len(sigs)} static signatures; split with "
            "repro_torch.sweep.partition")
    srcs = [as_source(s) for s in sources]
    devices = shard_devices(resolve_device(device), shard)
    systems = [system_for(points[0],
                          geometry_alloc=batch_geometry_alloc(points),
                          traced_geometry=mixed_geometry(points), device=d)
               for d in devices]
    system = systems[0]
    dev = system.device
    for b, src in enumerate(srcs):
        if src.n_cores is not None and src.n_cores != system.n_cores:
            raise ValueError(f"source for point [{b}] has {src.n_cores} "
                             f"cores, the batch has {system.n_cores}")
    n_pts, nc = len(points), system.n_cores
    pad = _pad_points(n_pts, len(devices))
    tn_b = stack_tunables(points, system.p.queue_depth, dev)
    pri_b = (_stack_priors(region_priors, n_pts)
             if region_priors is not None else None)
    # each point's fault schedule (the fault leaf is saved and restored
    # with the rest of the state)
    st_b = system.init_batch(tn_b, pri_b,
                             _stack_faults(points, system.p, dev))
    pos = np.zeros((n_pts, nc), np.int64)
    bound = chunk_bound(system, chunk_len)
    win_r: List[List[tuple]] = [[] for _ in range(n_pts)]
    win_w: List[List[tuple]] = [[] for _ in range(n_pts)]
    ckpt = None
    step = 0
    if checkpoint_dir is not None and checkpoint_every > 0:
        from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                            restore)
        ckpt = CheckpointManager(checkpoint_dir, keep=2)
        last = latest_step(checkpoint_dir) if resume else None
        if last is not None:
            like = {"state": st_b, "pos": pos,
                    "wins": np.zeros(0, np.uint8)}
            tree = restore(checkpoint_dir, like, step=last)
            st_b = tree["state"]
            pos = np.asarray(tree["pos"], np.int64)
            win_r, win_w = _wins_unblob(tree["wins"])
            step = last
    elif resume:
        raise ValueError("resume=True needs checkpoint_dir and "
                         "checkpoint_every")
    host = torch.cat([_snapshot(st_b), st_b.mem.cycle.long()[:, None]],
                     1).tolist()
    prev = [h[:-1] for h in host]
    prev_cycle = np.array([h[-1] for h in host], np.int64)
    shards = _maybe_shard(_replicate_tail((st_b, tn_b), pad), devices)
    sts, tns = [s[0] for s in shards], [s[1] for s in shards]
    hook = gathered_hook(on_cycle, n_pts, dev)
    while True:
        staged = _maybe_shard(_replicate_tail(
            stage_batch(srcs, pos, chunk_len, dev), pad), devices)
        sts = [st._replace(core_ptr=torch.zeros_like(st.core_ptr))
               for st in sts]
        sts = run_chunk_shards(systems, sts, [t for t, _ in staged],
                               [se for _, se in staged], bound, tns, hook)
        rows = [torch.cat([st.core_ptr.long(),
                           quiescent(st).long()[:, None],
                           st.mem.cycle.long()[:, None], _snapshot(st)], 1)
                for st in sts]
        host = _gather(rows, n_pts, dev).tolist()
        moved = np.array([h[:nc] for h in host], np.int64)
        quiet = all(h[nc] for h in host)
        cycles = np.array([h[nc + 1] for h in host], np.int64)
        snap = [h[nc + 2:] for h in host]
        for b in range(n_pts):
            wr, ww = _window_stats(prev[b], snap[b])
            win_r[b].append(wr)
            win_w[b].append(ww)
        prev = snap
        pos += moved
        step += 1
        if ckpt is not None and step % checkpoint_every == 0:
            ckpt.save_async(step, {"state": _gather(sts, n_pts, dev),
                                   "pos": pos.copy(),
                                   "wins": _wins_blob(win_r, win_w)})
        if all(src.exhausted(pos[b]) for b, src in enumerate(srcs)) \
                and quiet:
            break
        if not moved.any() and (cycles - prev_cycle >= bound).all():
            break
        if max_cycles is not None and int(cycles.max()) >= max_cycles:
            break
        prev_cycle = cycles
    if ckpt is not None:
        ckpt.wait()
    return [res._replace(window_read_latency=tuple(win_r[b]),
                         window_write_latency=tuple(win_w[b]))
            for b, res in enumerate(summarize_batch(_gather(sts, n_pts,
                                                            dev)))]
