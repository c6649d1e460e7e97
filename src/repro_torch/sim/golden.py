"""The bridge between the port's simulator and its golden model.

``repro_torch.oracle`` re-derives the paper's memory cycle in plain NumPy,
one request at a time, sharing no code with ``repro_torch.core``. This
module configures that model like a port system and compares the two:

  * ``oracle_twin(system)`` — the ``OracleMemorySystem`` of a
    ``CodedMemorySystem``: the same allocation, the same ``*_active``
    geometry, tunables, telemetry and faults flags;
  * ``batch_twins(points)`` — the twin of each point of one
    ``run_batch`` batch, at the batch's padded allocation, and
    ``point_twins(points)`` those of a ``run_points`` call;
  * ``state_mismatches(state, ostate)`` — the names of the fields of one
    point's ``SimState`` that differ from the oracle's ``OracleState``:
    the memory arrays compared as bits (int32 lanes viewed unsigned), the
    scalars exactly, the int64 wide counters as integers, ``core_ptr``,
    ``done_cycle``, the telemetry planes and the fault leaf;
  * ``result_matches(res, ores)`` — a ``SimResult`` equals an
    ``OracleResult`` with its window series stripped.

The oracle's twins run on the host; the compared state may lie on any
device (it is copied to the host once).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.state import INT32_MAX, TunableParams, point_of
from repro_torch.faults.plan import FaultState, plan_from_spec
from repro_torch.obs.planes import Telemetry
from repro_torch.oracle import OracleMemorySystem, OracleParams

ARRAY_FIELDS = (
    "fresh_loc", "parity_valid", "region_slot", "slot_region",
    "access_count", "parked_count", "rc_bank", "rc_row", "rc_valid",
    "rq_row", "rq_age", "rq_valid", "wq_row", "wq_age", "wq_valid",
    "wq_data", "banks_data", "parity_data", "golden")
SCALAR_FIELDS = (
    "enc_region", "enc_remaining", "enc_slot", "switches", "write_mode",
    "cycle", "served_reads", "served_writes", "degraded_reads",
    "parked_writes", "rc_dropped")
WIDE_FIELDS = ("read_latency_sum", "write_latency_sum", "stall_cycles")


def _tunable(tn: TunableParams, name: str, point: int) -> int:
    v = getattr(tn, name)
    if isinstance(v, torch.Tensor) and v.dim() > 0:
        v = v[point]
    return int(v)


def oracle_params(p, tn: TunableParams, point: int = 0) -> OracleParams:
    """The ``OracleParams`` of a port ``MemParams`` ``p`` run with the
    tunables ``tn`` (one point's, or point ``point`` of a batch's): an
    INT32_MAX ``*_active`` tunable means the allocation."""
    def active(name, alloc):
        v = _tunable(tn, name, point)
        return alloc if v == INT32_MAX else min(v, alloc)

    return OracleParams(
        n_data=p.n_data, n_rows=p.n_rows, region_size=p.region_size,
        n_regions=p.n_regions, n_slots=p.n_slots, n_active=p.n_active,
        queue_depth=p.queue_depth, recode_cap=p.recode_cap,
        recode_budget=p.recode_budget, coalesce=p.coalesce,
        encode_rows_per_cycle=p.encode_rows_per_cycle,
        region_size_active=active("region_size_active", p.region_size),
        n_regions_active=active("n_regions_active", p.n_regions),
        n_slots_active=active("n_slots_active", p.n_active),
        select_period=_tunable(tn, "select_period", point),
        wq_hi=_tunable(tn, "wq_hi", point),
        wq_lo=_tunable(tn, "wq_lo", point),
        telemetry=p.telemetry, faults=p.faults)


def oracle_twin(system) -> OracleMemorySystem:
    """The golden model configured like ``system`` (a
    ``CodedMemorySystem``) run with its own tunables. The oracle derives
    its own scheme tables from the scheme's name."""
    return OracleMemorySystem(system.tables.scheme.name,
                              oracle_params(system.p, system.tunables),
                              n_cores=system.n_cores)


def batch_twins(points) -> List[OracleMemorySystem]:
    """The golden model of each point of one batch as ``run_batch`` runs
    it: each point at its own geometry inside the batch's padded
    allocation, on the system of the batch's first point (its telemetry
    and faults flags), with the batch's tunables."""
    from repro_torch.sweep.engine import (mixed_geometry, params_for,
                                          stack_tunables)
    from repro_torch.sweep.grid import batch_geometry_alloc

    p = params_for(points[0], batch_geometry_alloc(points),
                   mixed_geometry(points))
    tn = stack_tunables(points, p.queue_depth, "cpu")
    return [OracleMemorySystem(pt.scheme, oracle_params(p, tn, k),
                               n_cores=pt.n_cores)
            for k, pt in enumerate(points)]


def point_twins(points) -> List[OracleMemorySystem]:
    """The golden model of each of ``points`` as ``run_points`` runs it
    (one ``partition`` batch at a time), aligned with ``points``."""
    from repro_torch.sweep.grid import partition

    twins: List[Optional[OracleMemorySystem]] = [None] * len(points)
    for batch in partition(points):
        for i, twin in zip(batch.indices, batch_twins(batch.points)):
            twins[i] = twin
    return twins


def fault_plan_of(pt, twin: OracleMemorySystem):
    """The fault plan of sweep point ``pt`` for its twin (None without
    one)."""
    return plan_from_spec(pt.faults, twin.p.n_data, twin.scheme.n_ports)


def host_trace(trace) -> tuple:
    """A port ``Trace`` as the oracle's tuple of numpy arrays."""
    return tuple(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                 for x in trace)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want) -> bool:
    """Equal shapes and values; integer arrays of one width compare as
    bits (viewed unsigned), others as int64 values."""
    got, want = _host(got), np.asarray(want)
    if got.shape != want.shape:
        return False
    if got.dtype == want.dtype and got.dtype.kind == "i":
        u = np.dtype(f"u{got.dtype.itemsize}")
        return bool(np.array_equal(np.ascontiguousarray(got).view(u),
                                   np.ascontiguousarray(want).view(u)))
    if got.dtype == bool and want.dtype == bool:
        return bool(np.array_equal(got, want))
    return bool(np.array_equal(got.astype(np.int64), want.astype(np.int64)))


def state_mismatches(state, ostate, point: int = 0) -> List[str]:
    """The names of the fields of point ``point`` of the port ``SimState``
    ``state`` (batched, or one point's) that differ from the oracle's
    ``ostate``; empty when every field is equal. Telemetry planes are
    named ``tele.<plane>``, fault fields ``fault.<field>``."""
    if state.done_cycle.dim() > 0:
        state = point_of(state, point)
    host = _to_host(state)
    m = host.mem
    bad = [name for name in ARRAY_FIELDS
           if not _same(getattr(m, name), getattr(ostate, name))]
    bad += [name for name in SCALAR_FIELDS + WIDE_FIELDS
            if int(getattr(m, name)) != int(getattr(ostate, name))]
    if not _same(host.core_ptr, ostate.core_ptr):
        bad.append("core_ptr")
    if int(host.done_cycle) != int(ostate.done_cycle):
        bad.append("done_cycle")
    bad += _leaf_mismatches("tele", Telemetry, m.tele, ostate.tele)
    bad += _leaf_mismatches("fault", FaultState, m.fault, ostate.fault)
    return bad


def _leaf_mismatches(name, cls, got, want) -> List[str]:
    if (got is None) != (want is None):
        return [f"{name} (present on one side only)"]
    if got is None:
        return []
    return [f"{name}.{f}" for f in cls._fields
            if not _same(getattr(got, f), getattr(want, f))]


def _to_host(tree):
    """``tree`` (nested NamedTuples of tensors) with every tensor on the
    host."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, tuple):
        return type(tree)(*(_to_host(x) for x in tree))
    return tree


def result_mismatches(res, ores) -> List[str]:
    """The names of the fields of a port ``SimResult`` that differ from an
    ``OracleResult``, the window series aside (the oracle keeps none)."""
    return [f for f in ores._fields
            if not f.startswith("window_")
            and getattr(res, f) != getattr(ores, f)]


def result_matches(res, ores) -> bool:
    """A port ``SimResult`` equals an ``OracleResult``, the window series
    stripped."""
    return not result_mismatches(res, ores)


def check_run(state, res, twin: OracleMemorySystem, trace, n_cycles: int,
              fault_plan=None, point: int = 0) -> List[str]:
    """Run ``twin`` from its initial state over ``trace`` for exactly
    ``n_cycles`` cycles (the cycles the port ran) and name what of the
    port's final ``state`` and ``res`` differs: state fields, then
    ``result.<field>``."""
    ost = twin.run(host_trace(trace), n_cycles,
                   st=twin.init_state(fault_plan=fault_plan))
    bad = state_mismatches(state, ost, point)
    bad += [f"result.{f}" for f in result_mismatches(res, twin.result(ost))]
    return bad
