"""Trace-driven evaluation substrate (the paper's gem5 + Ramulator stage),
port of ``repro/sim``.

``trace`` generates seeded synthetic multi-core memory traces with the
access-pattern structure the paper observes in PARSEC (persistent
sequential bands, Fig 15) and its two augmentations (split bands, Fig 16;
linear ramp, Fig 17). ``ramulator`` drives
``repro_torch.core.CodedMemorySystem`` over a trace and compares coded
schemes against the uncoded baseline.
"""
from repro_torch.sim.trace import (  # noqa: F401
    TraceSpec,
    banded_trace,
    ramp_trace,
    split_band_trace,
    uniform_trace,
    zipf_trace,
)
from repro_torch.sim.ramulator import (  # noqa: F401
    compare_schemes,
    simulate,
    sweep_alpha,
)
