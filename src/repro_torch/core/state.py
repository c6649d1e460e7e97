"""State of the coded memory system (controller + banks), as torch tensors.

The port of ``repro/core/state.py``. The freshness model is the same:

  * ``fresh_loc[b, i]`` — where the fresh value of data bank ``b`` row
    ``i`` lives: ``0`` = in the data bank; ``j+1`` = parked raw in logical
    parity ``j``'s row slot (paper status ``10``).
  * ``parity_valid[j, r]`` — logical parity ``j``'s slot row ``r`` equals
    the XOR of its members' data-bank rows.

Dynamic coding (§IV-E) groups rows into ``n_regions`` regions of
``region_size`` rows; ``region_slot[g]`` maps region ``g`` to a parity slot
(or -1), giving parity row ``region_slot[i // rs] * rs + i % rs``.

Differences from the JAX state, all of representation only:

  * the wide statistics (``read_latency_sum``, ``write_latency_sum``,
    ``stall_cycles``) are native 0-d ``int64`` tensors where JAX keeps
    (lo, hi) uint32 limb pairs; ``repro_torch.convert`` maps between them;
  * ``TunableParams`` holds python ints: the port runs one point at a time.

This slice carries no telemetry planes, no fault schedule and no traced
(padded) geometry: those flags and fault plans raise
``NotImplementedError``, the ``tele``/``fault`` leaves stay ``None``, and
``make_params`` takes none of the padded-allocation arguments the JAX sweep
engine passes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.codes import CodeTables

INT32_MAX = int(np.iinfo(np.int32).max)


class MemParams(NamedTuple):
    """Static geometry (python ints), field for field the JAX ``MemParams``."""

    n_data: int
    n_parities: int
    n_ports: int          # data + physical parity banks
    n_rows: int           # L, rows per data bank
    region_size: int      # rs (allocated stride of one parity slot)
    n_regions: int        # ceil(L / rs)
    n_slots: int          # parity slots (≥1 storage floor)
    n_active: int         # slots usable for coded regions (0 when α < r)
    queue_depth: int
    recode_cap: int
    max_syms: int
    recode_budget: int    # max recode entries retired per cycle
    coalesce: bool        # allow FROM_SYM / chained-decode reuse
    encode_rows_per_cycle: int = 64
    traced_geometry: bool = False
    telemetry: bool = False
    faults: bool = False


class TunableParams(NamedTuple):
    """Per-point scalar knobs (python ints)."""

    select_period: int
    wq_hi: int
    wq_lo: int
    n_slots_active: int
    region_size_active: int
    n_regions_active: int


def make_tunables(
    queue_depth: int = 10,
    select_period: int = 512,
    wq_hi: int = 8,
    wq_lo: int = 2,
    n_slots_active: int = INT32_MAX,
    region_size_active: int = INT32_MAX,
    n_regions_active: int = INT32_MAX,
) -> TunableParams:
    hi = min(int(wq_hi), queue_depth - 1)
    return TunableParams(
        select_period=max(int(select_period), 1),
        wq_hi=hi,
        # crossed thresholds (lo > hi) would flap write_mode every cycle
        wq_lo=min(int(wq_lo), hi),
        n_slots_active=int(n_slots_active),
        region_size_active=int(region_size_active),
        n_regions_active=int(n_regions_active),
    )


def active_geometry(p: MemParams, tn: TunableParams):
    """(region_size_active, n_regions_active): the allocation itself, since
    the port has no traced (padded sweep) geometry yet."""
    return p.region_size, p.n_regions


def derive_geometry(n_rows: int, alpha: float, r: float):
    """(region_size, n_regions, n_slots) implied by an (n_rows, α, r) point;
    ``n_slots`` is 0 when α < r (the point is uncoded)."""
    region_size = max(1, int(round(n_rows * r)))
    n_regions = -(-n_rows // region_size)
    n_slots = min(int(np.floor(alpha / r + 1e-9)), n_regions)
    return region_size, n_regions, max(n_slots, 0)


def make_params(
    tables: CodeTables,
    n_rows: int,
    alpha: float,
    r: float,
    queue_depth: int = 10,
    recode_cap: int = 64,
    max_syms: int = 96,
    encode_rows_per_cycle: int = 64,
    recode_budget: int = 4,
    coalesce: bool = True,
    traced_geometry: bool = False,
    telemetry: bool = False,
    faults: bool = False,
) -> MemParams:
    for flag, name in ((traced_geometry, "traced_geometry"),
                       (telemetry, "telemetry"), (faults, "faults")):
        if flag:
            raise NotImplementedError(f"make_params({name}=True) is not "
                                      "ported yet")
    if max_syms < tables.n_ports:
        raise ValueError(
            f"max_syms={max_syms} < n_ports={tables.n_ports}: the symbol "
            "capacity must cover the per-cycle port-claim bound")
    region_size, n_regions, n_slots = derive_geometry(n_rows, alpha, r)
    # ⌊α/r⌋ active regions, as in the paper's §V-C experiments
    n_active = n_slots
    return MemParams(
        n_data=tables.n_data,
        n_parities=max(tables.n_parities, 1),
        n_ports=tables.n_ports,
        n_rows=n_rows,
        region_size=region_size,
        n_regions=n_regions,
        n_slots=max(n_slots, 1),   # storage floor; the true budget is n_active
        n_active=n_active,
        queue_depth=queue_depth,
        recode_cap=recode_cap,
        max_syms=max_syms,
        recode_budget=recode_budget,
        coalesce=coalesce if tables.n_parities > 0 else False,
        encode_rows_per_cycle=encode_rows_per_cycle,
    )


class MemState(NamedTuple):
    """Dynamic controller state; the field order of the JAX ``MemState``."""

    fresh_loc: torch.Tensor      # (n_data, L) int32
    parity_valid: torch.Tensor   # (n_par, n_slots * rs) bool
    region_slot: torch.Tensor    # (n_regions,) int32, -1 = uncoded
    slot_region: torch.Tensor    # (n_slots,) int32, -1 = free/staging
    access_count: torch.Tensor   # (n_regions,) int32 (windowed)
    parked_count: torch.Tensor   # (n_regions,) int32
    enc_region: torch.Tensor     # () int32, -1 = idle
    enc_remaining: torch.Tensor  # () int32
    enc_slot: torch.Tensor       # () int32
    switches: torch.Tensor       # () int32
    rc_bank: torch.Tensor        # (RC,) int32
    rc_row: torch.Tensor         # (RC,) int32
    rc_valid: torch.Tensor       # (RC,) bool
    rq_row: torch.Tensor         # (n_data, D) int32
    rq_age: torch.Tensor         # (n_data, D) int32 (INT32_MAX empty)
    rq_valid: torch.Tensor       # (n_data, D) bool
    wq_row: torch.Tensor
    wq_age: torch.Tensor
    wq_valid: torch.Tensor
    wq_data: torch.Tensor        # (n_data, D) int32 write payloads
    write_mode: torch.Tensor     # () bool
    cycle: torch.Tensor          # () int32
    banks_data: torch.Tensor     # (n_data, L) int32
    parity_data: torch.Tensor    # (n_par, n_slots * rs) int32
    golden: torch.Tensor         # (n_data, L) int32 memory-order reference
    served_reads: torch.Tensor   # () int32
    served_writes: torch.Tensor  # () int32
    degraded_reads: torch.Tensor  # () int32
    parked_writes: torch.Tensor  # () int32
    read_latency_sum: torch.Tensor   # () int64
    write_latency_sum: torch.Tensor  # () int64
    stall_cycles: torch.Tensor       # () int64
    rc_dropped: torch.Tensor     # () int32
    tele: None = None
    fault: None = None


WIDE_FIELDS = ("read_latency_sum", "write_latency_sum", "stall_cycles")


def init_state(p: MemParams, tn: Optional[TunableParams] = None,
               region_priors=None, n_cores: int = 8, fault_plan=None,
               device="cpu") -> MemState:
    """Initial controller state on ``device`` (``n_cores`` only sized the
    telemetry planes in JAX and is unused here). ``region_priors`` (a
    sub-coverage system only) is a ranked array of hot region ids, -1
    padded, pre-mapped into parity slots (``dynamic.priors_layout``)."""
    if fault_plan is not None:
        raise NotImplementedError("fault plans are not ported yet")
    if tn is not None:
        for v, alloc, name in ((tn.region_size_active, p.region_size,
                                "region_size_active"),
                               (tn.n_regions_active, p.n_regions,
                                "n_regions_active")):
            if int(v) not in (alloc, INT32_MAX):
                raise ValueError(
                    f"TunableParams.{name}={int(v)} differs from the "
                    f"allocation ({alloc}) and traced geometry is not ported")
    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    n_slot_rows = p.n_slots * p.region_size
    if p.n_active >= p.n_regions:
        # static full coverage: identity region->slot map, all parities valid
        region_slot = torch.arange(p.n_regions, **i32)
        slot_region = torch.arange(p.n_slots, **i32)
        parity_valid = torch.ones((p.n_parities, n_slot_rows), dtype=torch.bool,
                                  device=dev)
    elif region_priors is not None:
        from repro_torch.core.dynamic import priors_layout
        region_slot, slot_region, parity_valid = priors_layout(
            p, tn, region_priors, dev)
    else:
        region_slot = torch.full((p.n_regions,), -1, **i32)
        slot_region = torch.full((p.n_slots,), -1, **i32)
        parity_valid = torch.zeros((p.n_parities, n_slot_rows),
                                   dtype=torch.bool, device=dev)

    def z():
        return torch.zeros((), **i32)

    def wide():
        return torch.zeros((), dtype=torch.int64, device=dev)

    nq = (p.n_data, p.queue_depth)
    return MemState(
        fresh_loc=torch.zeros((p.n_data, p.n_rows), **i32),
        parity_valid=parity_valid,
        region_slot=region_slot,
        slot_region=slot_region,
        access_count=torch.zeros((p.n_regions,), **i32),
        parked_count=torch.zeros((p.n_regions,), **i32),
        enc_region=torch.full((), -1, **i32),
        enc_remaining=z(),
        enc_slot=torch.full((), -1, **i32),
        switches=z(),
        rc_bank=torch.full((p.recode_cap,), -1, **i32),
        rc_row=torch.full((p.recode_cap,), -1, **i32),
        rc_valid=torch.zeros((p.recode_cap,), dtype=torch.bool, device=dev),
        rq_row=torch.full(nq, -1, **i32),
        rq_age=torch.full(nq, INT32_MAX, **i32),
        rq_valid=torch.zeros(nq, dtype=torch.bool, device=dev),
        wq_row=torch.full(nq, -1, **i32),
        wq_age=torch.full(nq, INT32_MAX, **i32),
        wq_valid=torch.zeros(nq, dtype=torch.bool, device=dev),
        wq_data=torch.zeros(nq, **i32),
        write_mode=torch.zeros((), dtype=torch.bool, device=dev),
        cycle=z(),
        banks_data=torch.zeros((p.n_data, p.n_rows), **i32),
        parity_data=torch.zeros((p.n_parities, n_slot_rows), **i32),
        golden=torch.zeros((p.n_data, p.n_rows), **i32),
        served_reads=z(),
        served_writes=z(),
        degraded_reads=z(),
        parked_writes=z(),
        read_latency_sum=wide(),
        write_latency_sum=wide(),
        stall_cycles=wide(),
        rc_dropped=z(),
    )
