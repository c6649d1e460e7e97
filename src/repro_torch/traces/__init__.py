"""Streaming DRAM-trace replay, ingestion and profiling, port of
``repro/traces``:

  stream   — ``stream_replay``: arbitrarily long traces as fixed-shape
             chunks with an explicit ``SimState`` carry, equal to
             single-shot ``run()`` and leaving at quiescence;
             ``stream_replay_points``: a batch of sweep points lock-step,
             with checkpointed resume
  source   — bounded rolling-window ``TraceSource`` with background chunk
             prefetch
  formats  — Ramulator / gem5 text parsers and the ``.npz`` form, with the
             address mapping of ``repro_torch.sim.trace``
  profiler — streaming locality statistics (Fig 15 bands, read/write mix,
             burstiness) and the region priors that warm-start the
             dynamic coding unit

Streaming a trace file on the CPU:

    from repro_torch.traces import stream_file, stream_replay, profile_trace
    res = stream_replay(system, stream_file("app.trace", 256), chunk_len=256)
"""
from repro_torch.traces.formats import (  # noqa: F401
    TraceFormatError,
    count_requests,
    load_npz,
    load_trace,
    probe,
    requests_to_trace,
    save_npz,
    stream_file,
)
from repro_torch.traces.profiler import (  # noqa: F401
    Band,
    TraceProfile,
    TraceProfiler,
    profile_trace,
)
from repro_torch.traces.source import (  # noqa: F401
    TraceSource,
    as_source,
    chunk_iter,
)
from repro_torch.traces.stream import (  # noqa: F401
    chunk_bound,
    stream_replay,
    stream_replay_points,
    strip_windows,
)
