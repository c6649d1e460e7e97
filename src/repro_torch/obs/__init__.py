"""Observability of the port (``repro/obs`` counterpart):

* ``planes``   — the simulator's telemetry planes behind
                 ``MemParams.telemetry`` (per-bank stall and wait causes,
                 per-core read/write provenance with the fault class, queue
                 high-water marks, critical-word latency histograms);
* ``timeline`` — Chrome-trace JSON of the scheduler's decisions, one
                 host-stepped cycle at a time;
* ``report``   — the stall-attribution and availability reports of a
                 paper suite, planes checked against the aggregates;
* ``runlog``   — run manifests for result artefacts;
* ``serve``    — the serving path's planes and request spans.

``core/state.py`` imports ``planes``; the other modules pull in the sweep
layer, so they load lazily and the core's imports stay acyclic.
"""
from repro_torch.obs.planes import (HIST_BINS, READ_CLASSES, STALL_CAUSES,
                                    WAIT_CAUSES, WRITE_CLASSES, Telemetry,
                                    TelemetrySnapshot, init_telemetry,
                                    lat_bin, snapshot)

__all__ = [
    "HIST_BINS", "READ_CLASSES", "STALL_CAUSES", "WAIT_CAUSES",
    "WRITE_CLASSES", "Telemetry", "TelemetrySnapshot", "init_telemetry",
    "lat_bin", "snapshot", "timeline", "runlog", "report", "serve",
]


def __getattr__(name):
    if name in ("timeline", "runlog", "report", "serve"):
        import importlib
        return importlib.import_module(f"repro_torch.obs.{name}")
    raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                         f"{name!r}")
