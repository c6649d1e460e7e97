"""The coded memory system (paper §III–IV) in PyTorch: code tables, state,
pattern builders, the ReCoding and dynamic coding units, one cycle; the
port of ``repro/core``.

Public surface:
  codes      — Scheme I/II/III + replication/uncoded baselines (§III)
  state      — MemParams/MemState (code status table refinement, §IV-A)
  controller — read/write pattern builders (§IV-B/C)
  recoding   — ReCoding unit (§IV-D)
  dynamic    — dynamic coding unit (§IV-E)
  system     — CodedMemorySystem cycle engine + trace-driven run()

JAX's ``wide_add``/``wide_zero``/``wide_total`` have no counterpart: the
port's wide counters are native int64 tensors.
"""
from repro_torch.core.codes import (  # noqa: F401
    MAX_OPTS,
    MAX_SIBS,
    CodeScheme,
    CodeTables,
    SCHEMES,
    get_tables,
    replication,
    scheme_i,
    scheme_ii,
    scheme_iii,
    uncoded,
)
from repro_torch.core.controller import (  # noqa: F401
    MODE_DIRECT,
    MODE_FROM_SYM,
    MODE_OPT0,
    MODE_REDIRECT,
    MODE_UNSERVED,
    WMODE_DIRECT,
    WMODE_PARK0,
    WMODE_UNSERVED,
    JTables,
    ReadPlan,
    WritePlan,
    build_read_pattern,
    build_write_pattern,
    jtables,
)
from repro_torch.core.state import (  # noqa: F401
    MemParams,
    MemState,
    TunableParams,
    active_geometry,
    derive_geometry,
    init_state,
    make_params,
    make_tunables,
)

from repro_torch.core.system import (  # noqa: F401
    CodedMemorySystem,
    CycleOut,
    SimResult,
    SimState,
    Trace,
)
