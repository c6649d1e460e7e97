"""Fault model: per-bank erasure schedules and transient port stutters; the
port of ``repro/faults/plan.py``.

A fault plan is a static schedule attached to one simulated point:

* **Bank erasure** — data bank ``b`` fails at ``fail_at[b]`` (its single
  port reads permanently busy; its stored rows are unreadable) and
  optionally begins recovery at ``recover_at[b]``. A recovering bank's
  rows are rebuilt through the ReCoding ring (``repro_torch.faults.
  inject``); the bank rejoins service once the rebuild sweep completes
  (``rebuilt[b]`` latches). Only data banks fail.
* **Port stutter** — port ``q`` (data or parity) is busy one cycle out of
  every ``stutter_period[q]``, at phase ``stutter_phase[q]``. Stutters
  lose no data.

The schedule and its progress ride the state as the ``FaultState`` leaf of
``MemState`` behind ``MemParams.faults``: with the flag off the leaf is
None and the cycle runs exactly as before faults existed. The schedule
being state, not code, is what lets one batch carry points with different
plans. One point's leaf has the shapes noted below; a batch's has a
leading (B,) axis on every tensor. With ``MemParams.telemetry`` on too,
the planes' ``dead_cycles`` (``repro_torch.obs.planes``) count the same
cycles as this leaf's, and reads served degraded because their bank is
down are the planes' read class 4.

This module imports nothing of ``repro_torch`` (``core.state`` imports
it for the leaf type).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

INT32_MAX = int(np.iinfo(np.int32).max)
NEVER = INT32_MAX   # fail_at / recover_at sentinel: the event never happens


class FaultState(NamedTuple):
    """Per-point fault schedule and progress (a ``MemState`` leaf).

    The schedule half (``fail_at`` … ``stutter_phase``) is constant over a
    run; the rest changes each cycle. ``dead_cycles`` is int64 where JAX
    keeps uint32 (``repro_torch.convert`` maps between them)."""

    fail_at: torch.Tensor         # (n_data,) int32; NEVER = no failure
    recover_at: torch.Tensor      # (n_data,) int32; NEVER = no recovery
    stutter_period: torch.Tensor  # (n_ports,) int32; 0 = no stutter
    stutter_phase: torch.Tensor   # (n_ports,) int32
    rebuilt: torch.Tensor         # (n_data,) bool, rebuild-complete latch
    rebuild_ptr: torch.Tensor     # () int32 flat (bank * n_rows + row)
                                  # cursor of the online rebuild sweep
    unserved_reads: torch.Tensor  # () int32, reads failed fast
    lost_writes: torch.Tensor     # () int32, writes with no parity to park
    fault_degraded: torch.Tensor  # () int32, reads degraded because their
                                  # bank is down (within degraded_reads)
    dead_cycles: torch.Tensor     # (n_data,) int64, cycles spent down


def init_fault_state(n_data: int, n_ports: int,
                     device="cpu") -> FaultState:
    """The no-fault schedule (nothing ever fails or stutters)."""
    i32 = dict(dtype=torch.int32, device=device)
    return FaultState(
        fail_at=torch.full((n_data,), NEVER, **i32),
        recover_at=torch.full((n_data,), NEVER, **i32),
        stutter_period=torch.zeros((n_ports,), **i32),
        stutter_phase=torch.zeros((n_ports,), **i32),
        rebuilt=torch.zeros((n_data,), dtype=torch.bool, device=device),
        rebuild_ptr=torch.zeros((), **i32),
        unserved_reads=torch.zeros((), **i32),
        lost_writes=torch.zeros((), **i32),
        fault_degraded=torch.zeros((), **i32),
        dead_cycles=torch.zeros((n_data,), dtype=torch.int64, device=device),
    )


def stack_fault_states(states: Sequence[FaultState]) -> FaultState:
    """One point's ``FaultState`` each → one batched ``FaultState``."""
    return FaultState(*(torch.stack(xs) for xs in zip(*states)))


# --------------------------------------------------- per-cycle predicates
def _cyc(f: FaultState, cycle):
    """``cycle`` shaped to broadcast over the leaf's per-bank axis: a
    batch's (B,) cycle becomes (B, 1)."""
    if isinstance(cycle, torch.Tensor) and f.fail_at.dim() > 1:
        return cycle[..., None]
    return cycle


def bank_down(f: FaultState, cycle) -> torch.Tensor:
    """(…, n_data): failed and not yet rebuilt (dead or rebuilding); the
    pattern builders treat a down bank's port as permanently busy."""
    return (f.fail_at <= _cyc(f, cycle)) & ~f.rebuilt


def bank_rebuilding(f: FaultState, cycle) -> torch.Tensor:
    """(…, n_data): recovery has begun but the rebuild sweep has not
    finished; only the ReCoding unit may use the bank's port."""
    return bank_down(f, cycle) & (f.recover_at <= _cyc(f, cycle))


def stutter_busy(f: FaultState, cycle) -> torch.Tensor:
    """(…, n_ports): the ports transiently busy this cycle."""
    per = f.stutter_period
    return (per > 0) & (_cyc(f, cycle) % per.clamp(min=1)
                        == f.stutter_phase)


# ------------------------------------------------------- host-side plans
@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Hashable host-side fault schedule (the sweep-axis value).

    ``bank_faults`` — ``(bank, fail_at, recover_at)`` triples;
    ``recover_at < 0`` means the bank never recovers. ``stutters`` —
    ``(port, period, phase)`` triples. Build from a flat spec tuple (the
    ``SweepPoint.faults`` grammar) with ``from_spec``; lower to the state
    leaf with ``state(device)``."""

    n_data: int
    n_ports: int
    bank_faults: Tuple[Tuple[int, int, int], ...] = ()
    stutters: Tuple[Tuple[int, int, int], ...] = ()

    def __post_init__(self):
        for b, fail, rec in self.bank_faults:
            if not 0 <= b < self.n_data:
                raise ValueError(f"fault bank {b} out of range "
                                 f"[0, {self.n_data})")
            if fail < 0:
                raise ValueError(f"bank {b}: fail_at={fail} < 0")
            if 0 <= rec <= fail:
                raise ValueError(
                    f"bank {b}: recover_at={rec} <= fail_at={fail}")
        seen = set()
        for b, _, _ in self.bank_faults:
            if b in seen:
                raise ValueError(f"bank {b} listed twice in bank_faults")
            seen.add(b)
        for q, per, ph in self.stutters:
            if not 0 <= q < self.n_ports:
                raise ValueError(f"stutter port {q} out of range "
                                 f"[0, {self.n_ports})")
            if per <= 0 or not 0 <= ph < per:
                raise ValueError(
                    f"port {q}: need period > 0 and 0 <= phase < period "
                    f"(got period={per}, phase={ph})")

    @staticmethod
    def from_spec(spec: Tuple, n_data: int, n_ports: int) -> "FaultPlan":
        """Parse the flat ``SweepPoint.faults`` grammar:
        ``("bank", b, fail_at[, recover_at])`` and
        ``("stutter", port, period[, phase])`` entries."""
        banks, stutters = [], []
        for entry in spec:
            kind, rest = entry[0], entry[1:]
            if kind == "bank":
                b, fail = int(rest[0]), int(rest[1])
                rec = int(rest[2]) if len(rest) > 2 else -1
                banks.append((b, fail, rec))
            elif kind == "stutter":
                q, per = int(rest[0]), int(rest[1])
                ph = int(rest[2]) if len(rest) > 2 else 0
                stutters.append((q, per, ph))
            else:
                raise ValueError(f"unknown fault spec entry kind {kind!r} "
                                 "(want 'bank' or 'stutter')")
        return FaultPlan(n_data=n_data, n_ports=n_ports,
                         bank_faults=tuple(banks), stutters=tuple(stutters))

    def schedule_arrays(self):
        """(fail_at, recover_at, stutter_period, stutter_phase) as numpy
        int32 arrays."""
        fail = np.full(self.n_data, NEVER, np.int32)
        rec = np.full(self.n_data, NEVER, np.int32)
        per = np.zeros(self.n_ports, np.int32)
        ph = np.zeros(self.n_ports, np.int32)
        for b, f_at, r_at in self.bank_faults:
            fail[b] = f_at
            rec[b] = r_at if r_at >= 0 else NEVER
        for q, p_, ph_ in self.stutters:
            per[q] = p_
            ph[q] = ph_
        return fail, rec, per, ph

    def state(self, device="cpu") -> FaultState:
        """One point's ``FaultState`` on ``device``."""
        fail, rec, per, ph = (torch.from_numpy(a).to(device)
                              for a in self.schedule_arrays())
        return init_fault_state(self.n_data, self.n_ports, device)._replace(
            fail_at=fail, recover_at=rec, stutter_period=per,
            stutter_phase=ph)


def plan_from_spec(spec: Optional[Tuple], n_data: int,
                   n_ports: int) -> Optional[FaultPlan]:
    """None/() → None (no plan); otherwise ``FaultPlan.from_spec``."""
    if not spec:
        return None
    return FaultPlan.from_spec(tuple(spec), n_data, n_ports)
