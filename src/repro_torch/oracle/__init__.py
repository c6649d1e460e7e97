"""The port's NumPy golden models ("oracles"), copies of the JAX
package's: no torch and no code shared with the modules they check.

  codes  — scheme tables re-derived from the paper (§III)
  model  — ``OracleMemorySystem`` (cycle engine, plan builders, recode,
           dynamic coding), ``OracleParams.derive``, ``OracleResult``: the
           golden model of the memory cycle behind ``repro_torch.sim.golden``
  kvpool — the serving KV pool's plan, latency and telemetry recompute
           (the golden model behind ``obs.serve`` and ``obs.report
           --serve``)
"""
from repro_torch.oracle.codes import (  # noqa: F401
    MAX_OPTS,
    MAX_SIBS,
    ORACLE_SCHEMES,
    OracleScheme,
    oracle_scheme,
)
from repro_torch.oracle.kvpool import (  # noqa: F401
    PlaneTotals,
    StepExpectation,
    expected_step,
    plane_totals,
)
from repro_torch.oracle.model import (  # noqa: F401
    MODE_DIRECT,
    MODE_FROM_SYM,
    MODE_OPT0,
    MODE_REDIRECT,
    MODE_UNSERVED,
    WMODE_DIRECT,
    WMODE_PARK0,
    WMODE_UNSERVED,
    OracleCycleOut,
    OracleMemorySystem,
    OracleParams,
    OracleReadPlan,
    OracleRecodeOut,
    OracleResult,
    OracleState,
    OracleTelemetry,
    OracleWritePlan,
    build_read_plan,
    build_write_plan,
    recode_step,
)
