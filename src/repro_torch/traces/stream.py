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

Each ``run_chunk`` return is a window boundary: the served-count and
latency-sum differences between boundaries give the per-window read and
write latency series in ``SimResult.window_read_latency`` /
``window_write_latency``. The port's latency sums are native int64, so the
differences are taken directly, and each window's averages come from the
same integers as JAX's.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.state import TunableParams
from repro_torch.core.system import (CodedMemorySystem, SimResult, SimState,
                                     drain_bound, quiescent)
from repro_torch.traces.source import as_source

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
    """((n_reads, avg_read_lat), (n_writes, avg_write_lat)) of one window,
    from two ``_snapshot`` readings as ints."""
    dr = now[0] - prev[0]
    dw = now[1] - prev[1]
    return (dr, (now[2] - prev[2]) / max(dr, 1)), \
        (dw, (now[3] - prev[3]) / max(dw, 1))


def _snapshot(st: SimState) -> torch.Tensor:
    """(served_reads, served_writes, read_latency_sum, write_latency_sum)
    as one int64 tensor."""
    m = st.mem
    return torch.stack([m.served_reads.long(), m.served_writes.long(),
                        m.read_latency_sum, m.write_latency_sum])


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


def stream_replay_points(*args, **kwargs):
    """Chunked replay of a batch of sweep points (JAX
    ``repro/traces/stream.py::stream_replay_points``) and its checkpointed
    resume need the sweep engine's point axis, which is not ported yet
    (ROADMAP queue 1 item 2)."""
    raise NotImplementedError(
        "stream_replay_points needs the sweep engine's point axis, which "
        "is not ported yet (ROADMAP queue 1 item 2); replay one point at a "
        "time with stream_replay")
