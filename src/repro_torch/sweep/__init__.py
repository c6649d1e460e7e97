"""Batched sweep engine, port of ``repro/sweep``: whole design-space sweeps
as a handful of lock-step batches on the core's point axis.

  grid      — SweepPoint coordinates + static-shape partitioning (one batch
              per partition)
  workloads — named scenario suites; trace materialization + stacking
  engine    — ``run_batch`` / ``run_points`` / ``run_sweep``
  results   — flat result tables, JSON/CSV export, baseline normalization

On the CPU (entry points run on the card unless asked otherwise):

    from repro_torch.sweep import SweepPoint, grid, run_sweep
    pts = grid(SweepPoint(scheme="scheme_i", alpha=0.25, r=0.125,
                          n_rows=128, length=64), seed=range(4))
    rs = run_sweep(pts, device="cpu")        # one batch of 4, not 4 runs
    rs.to_csv("sweep.csv")
"""
from repro_torch.sweep.grid import (  # noqa: F401
    GridBatch,
    SweepPoint,
    grid,
    partition,
    static_signature,
)
from repro_torch.sweep.workloads import (  # noqa: F401
    SUITES,
    build_trace,
    stack_traces,
    suite,
)
from repro_torch.sweep.engine import (  # noqa: F401
    run_batch,
    run_points,
    run_sweep,
    stack_tunables,
    summarize_batch,
    system_for,
)
from repro_torch.sweep.results import (  # noqa: F401
    SweepRecord,
    SweepResultSet,
)
