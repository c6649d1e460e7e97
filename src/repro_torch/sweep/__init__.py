"""Batched sweep engine, port of ``repro/sweep``: whole design-space sweeps
as a handful of lock-step batches on the core's point axis.

  grid      — SweepPoint coordinates + static-shape partitioning (one batch
              per partition)
  workloads — trace materialization + stacking
  engine    — ``run_batch`` / ``run_points``

On the CPU (entry points run on the card unless asked otherwise):

    from repro_torch.sweep import SweepPoint, grid, run_points
    pts = grid(SweepPoint(scheme="scheme_i", alpha=0.25, r=0.125,
                          n_rows=128, length=64), seed=range(4))
    res = run_points(pts, device="cpu")      # one batch of 4, not 4 runs

The suites, ``run_sweep`` and the results store wait for ROADMAP queue 1
item 2b.
"""
from repro_torch.sweep.grid import (  # noqa: F401
    GridBatch,
    SweepPoint,
    grid,
    partition,
    static_signature,
)
from repro_torch.sweep.workloads import (  # noqa: F401
    build_trace,
    stack_traces,
)
from repro_torch.sweep.engine import (  # noqa: F401
    run_batch,
    run_points,
    stack_tunables,
    summarize_batch,
    system_for,
)
