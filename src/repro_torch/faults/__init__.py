"""Bank-fault injection, erasure-degraded serving and online rebuild; the
port of ``repro/faults``. ``plan`` holds the schedule (the ``MemState``
leaf and the host-side ``FaultPlan``), ``inject`` the cycle's hooks."""
from repro_torch.faults.plan import (NEVER, FaultPlan, FaultState,  # noqa: F401
                                     bank_down, bank_rebuilding,
                                     init_fault_state, plan_from_spec,
                                     stutter_busy)

__all__ = [
    "NEVER", "FaultPlan", "FaultState", "bank_down", "bank_rebuilding",
    "init_fault_state", "plan_from_spec", "stutter_busy",
]
