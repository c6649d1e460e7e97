"""The port's NumPy golden models ("oracles"), copies of the JAX
package's: no torch and no code shared with the modules they check.

  kvpool — the serving KV pool's plan, latency and telemetry recompute
           (the golden model behind ``obs.serve`` and ``obs.report
           --serve``)
"""
from repro_torch.oracle.kvpool import (  # noqa: F401
    PlaneTotals, StepExpectation, expected_step, plane_totals)
