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

The point axis. The cycle engine runs B points lock-step: every leaf of
a batched ``MemState`` has a leading (B,) axis (where JAX ``vmap``s the
unbatched state), and a batched ``TunableParams`` holds (B,) int32
tensors (``batch_tunables``). A single point is a batch of one
(``batch_of_one`` / ``point_of`` move between the two forms as views).

A sweep group may pad its region and parity state to the group maxima
(``make_params``' ``*_alloc`` arguments) and run each point at its own
traced geometry (``traced_geometry``, ``active_geometry``), as JAX does.

Differences from the JAX state, all of representation only:

  * the wide statistics (``read_latency_sum``, ``write_latency_sum``,
    ``stall_cycles``) are native ``int64`` tensors where JAX keeps
    (lo, hi) uint32 limb pairs; ``repro_torch.convert`` maps between them;
  * an unbatched ``TunableParams`` holds python ints.

With ``make_params(faults=True)`` the state carries a fault schedule and
its progress in the ``fault`` leaf (``repro_torch.faults.FaultState``,
batched like every other leaf); with the flag off the leaf is ``None``.
With ``make_params(telemetry=True)`` the ``tele`` leaf carries each
point's metric planes (``repro_torch.obs.planes.Telemetry``, batched
likewise; its counters int64 where JAX's are uint32); with the flag off it
is ``None``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.codes import CodeTables
from repro_torch.faults.plan import (FaultPlan, FaultState,
                                     init_fault_state, stack_fault_states)
from repro_torch.obs.planes import Telemetry, init_telemetries

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
    """Per-point scalar knobs: python ints for one point, (B,) int32
    tensors for a batch (``batch_tunables``). The ``*_active`` fields carry
    a point's own geometry inside a padded allocation; INT32_MAX clamps to
    the allocation."""

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


def batch_tunables(tns: Sequence[TunableParams], device) -> TunableParams:
    """Stack per-point tunables (python ints) into one batched
    ``TunableParams`` of (B,) int32 tensors on ``device``."""
    cols = torch.tensor([list(tn) for tn in tns], dtype=torch.int32)
    return TunableParams(*cols.T.contiguous().to(device).unbind(0))


def active_geometry(p: MemParams, tn: TunableParams):
    """(region_size_active, n_regions_active) of each point.

    Without ``p.traced_geometry`` these are the allocation's python ints
    (the ``*_active`` tunables then equal it by construction). With it they
    are (B,) tensors ``min(tn.*_active, alloc)`` of a batched ``tn``. Parity
    rows always keep the *allocated* slot stride: row ``i`` of a slot lives
    at ``slot * p.region_size + i % region_size_active``."""
    if not p.traced_geometry:
        return p.region_size, p.n_regions
    return (tn.region_size_active.clamp(max=p.region_size),
            tn.n_regions_active.clamp(max=p.n_regions))


def active_ints(p: MemParams, tn: Optional[TunableParams]):
    """``active_geometry`` of one point with python-int tunables, on the
    host: (region_size_active, n_regions_active)."""
    if tn is None or not p.traced_geometry:
        return p.region_size, p.n_regions
    return (min(int(tn.region_size_active), p.region_size),
            min(int(tn.n_regions_active), p.n_regions))


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        leaves = (_map(fn, x) for x in tree)
        return type(tree)(*leaves) if hasattr(tree, "_fields") \
            else tuple(leaves)
    return tree                          # None, python scalars


def batch_of_one(tree):
    """Every tensor leaf of ``tree`` (nested NamedTuples) with a leading
    point axis of 1 (views)."""
    return _map(lambda x: x[None], tree)


def point_of(tree, b: int):
    """Point ``b`` of a batched tree (views)."""
    return _map(lambda x: x[b], tree)


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
    n_slots_alloc: Optional[int] = None,
    region_size_alloc: Optional[int] = None,
    n_regions_alloc: Optional[int] = None,
    traced_geometry: bool = False,
    telemetry: bool = False,
    faults: bool = False,
) -> MemParams:
    """Static geometry of one (scheme, n_rows, α, r) point. The ``*_alloc``
    arguments pad the region and parity state to a sweep group's maxima
    (each at least the derived value; ``n_slots_alloc`` must not change
    full-coverage status); ``traced_geometry`` makes region indexing use
    each point's ``TunableParams.*_active`` geometry."""
    if max_syms < tables.n_ports:
        raise ValueError(
            f"max_syms={max_syms} < n_ports={tables.n_ports}: the symbol "
            "capacity must cover the per-cycle port-claim bound")
    region_size, n_regions, n_slots = derive_geometry(n_rows, alpha, r)
    full = n_slots >= n_regions
    if region_size_alloc is not None:
        if region_size_alloc < region_size:
            raise ValueError(f"region_size_alloc={region_size_alloc} < "
                             f"derived region_size={region_size}")
        region_size = region_size_alloc
    if n_regions_alloc is not None:
        if n_regions_alloc < n_regions:
            raise ValueError(f"n_regions_alloc={n_regions_alloc} < "
                             f"derived n_regions={n_regions}")
        n_regions = n_regions_alloc
    # ⌊α/r⌋ active regions, as in the paper's §V-C experiments
    n_active = n_slots
    if n_slots_alloc is not None:
        if n_slots_alloc < n_slots:
            raise ValueError(
                f"n_slots_alloc={n_slots_alloc} < derived n_slots={n_slots}")
        if (n_slots_alloc >= n_regions) != full:
            raise ValueError(
                "n_slots_alloc must not change full-coverage status "
                f"(alloc {n_slots_alloc}, derived {n_slots}, regions "
                f"{n_regions})")
        n_slots = n_active = n_slots_alloc
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
        traced_geometry=traced_geometry,
        telemetry=telemetry,
        faults=faults,
    )


class MemState(NamedTuple):
    """Dynamic controller state; the field order of the JAX ``MemState``.
    The shapes are one point's; a batched state has a leading (B,) axis on
    every leaf."""

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
    tele: Optional[Telemetry] = None     # None unless MemParams.telemetry
    fault: Optional[FaultState] = None   # None unless MemParams.faults


WIDE_FIELDS = ("read_latency_sum", "write_latency_sum", "stall_cycles")


def fault_states(p: MemParams, plans: Sequence[Optional[FaultPlan]],
                 device="cpu") -> Optional[FaultState]:
    """Each point's schedule (None: the no-fault one) as one batched
    ``FaultState`` on ``device``; None for a faults-off system. A plan
    given to a faults-off system, or of another geometry, raises JAX's
    errors."""
    for plan in plans:
        if plan is not None and not p.faults:
            raise ValueError("init_state got a fault_plan but the system "
                             "was built without make_params(faults=True) "
                             "— the schedule would be silently ignored")
        if plan is not None and (plan.n_data != p.n_data
                                 or plan.n_ports != p.n_ports):
            raise ValueError(
                f"FaultPlan geometry ({plan.n_data} data banks, "
                f"{plan.n_ports} ports) does not match MemParams "
                f"({p.n_data}, {p.n_ports})")
    if not p.faults:
        return None
    return stack_fault_states([
        plan.state(device) if plan is not None
        else init_fault_state(p.n_data, p.n_ports, device)
        for plan in plans])


def init_state(p: MemParams, tn: Optional[TunableParams] = None,
               region_priors=None, n_cores: int = 8,
               fault_plan: Optional[FaultPlan] = None,
               device="cpu") -> MemState:
    """One point's initial controller state on ``device``: ``init_states``
    on a batch of one (``n_cores`` sizes the telemetry planes' provenance;
    the telemetry-off state does not depend on it). ``fault_plan``
    installs an erasure/stutter schedule (``make_params(faults=True)``
    only); with the flag on and no plan, nothing ever fails."""
    fault = fault_states(p, [fault_plan], device)
    tn_b = batch_tunables([tn if tn is not None else make_tunables()],
                          device)
    pri = None if region_priors is None else [region_priors]
    return point_of(init_states(p, tn_b, pri, device, fault,
                                n_cores=n_cores), 0)


def init_states(p: MemParams, tn: TunableParams, region_priors=None,
                device="cpu", fault: Optional[FaultState] = None,
                n_cores: int = 8) -> MemState:
    """Initial controller states of a batch of points on ``device``; ``tn``
    is batched (``batch_tunables``). Each point's active geometry shapes its
    region map and parity validity inside the allocation: padded regions
    and slots stay unmapped (-1) and padded parity rows invalid, so a padded
    point equals an exactly allocated one. ``region_priors`` (a
    sub-coverage system only) is a (B, K) ranked array of hot region ids,
    -1 padded, pre-mapped into each point's parity slots
    (``dynamic.priors_layout``). ``fault`` is the batch's ``FaultState``
    (``fault_states``); on a faults system it defaults to the no-fault
    schedule of every point. ``n_cores`` sizes the telemetry planes
    (``make_params(telemetry=True)`` only)."""
    if fault is not None and not p.faults:
        raise ValueError("init_states got a fault schedule but the system "
                         "was built without make_params(faults=True)")
    dev = torch.device(device)
    host = torch.stack(list(tn)).T.tolist()        # (B, 6) python ints
    B = len(host)
    tns = [TunableParams(*h) for h in host]
    if not p.traced_geometry:
        for tnp in tns:
            for v, alloc, name in ((tnp.region_size_active, p.region_size,
                                    "region_size_active"),
                                   (tnp.n_regions_active, p.n_regions,
                                    "n_regions_active")):
                if v not in (alloc, INT32_MAX):
                    raise ValueError(
                        f"TunableParams.{name}={v} differs from the "
                        f"allocation ({alloc}) but the system was built "
                        "without make_params(traced_geometry=True)")
    i32 = dict(dtype=torch.int32, device=dev)
    n_slot_rows = p.n_slots * p.region_size
    if p.n_active >= p.n_regions and not p.traced_geometry:
        # static full coverage: identity region->slot map, all parities valid
        region_slot = torch.arange(p.n_regions, **i32).expand(B, -1)
        slot_region = torch.arange(p.n_slots, **i32).expand(B, -1)
        parity_valid = torch.ones((B, p.n_parities, n_slot_rows),
                                  dtype=torch.bool, device=dev)
    elif p.n_active >= p.n_regions:
        # the same inside a padded allocation: each point's own regions
        rs_a, nr_a = torch.tensor([active_ints(p, t) for t in tns],
                                  **i32).T[..., None]
        rid = torch.arange(p.n_regions, **i32)
        region_slot = torch.where(rid < nr_a, rid, -1)
        sid = torch.arange(p.n_slots, **i32)
        slot_region = torch.where(sid < nr_a, sid, -1)
        row = torch.arange(n_slot_rows, **i32)
        # the storage layout at the allocated stride
        active = (row // p.region_size < nr_a) & (row % p.region_size < rs_a)
        parity_valid = active[:, None].expand(B, p.n_parities,
                                              n_slot_rows).contiguous()
    elif region_priors is not None:
        from repro_torch.core.dynamic import priors_layout
        if isinstance(region_priors, torch.Tensor):
            region_priors = region_priors.cpu().numpy()
        layouts = [priors_layout(p, t, pr) for t, pr in
                   zip(tns, region_priors)]
        region_slot, slot_region, parity_valid = (
            torch.from_numpy(np.stack(a)).to(dev) for a in zip(*layouts))
    else:
        region_slot = torch.full((B, p.n_regions), -1, **i32)
        slot_region = torch.full((B, p.n_slots), -1, **i32)
        parity_valid = torch.zeros((B, p.n_parities, n_slot_rows),
                                   dtype=torch.bool, device=dev)

    def z():
        return torch.zeros((B,), **i32)

    def wide():
        return torch.zeros((B,), dtype=torch.int64, device=dev)

    nq = (B, p.n_data, p.queue_depth)
    return MemState(
        fresh_loc=torch.zeros((B, p.n_data, p.n_rows), **i32),
        parity_valid=parity_valid,
        region_slot=region_slot.contiguous(),
        slot_region=slot_region.contiguous(),
        access_count=torch.zeros((B, p.n_regions), **i32),
        parked_count=torch.zeros((B, p.n_regions), **i32),
        enc_region=torch.full((B,), -1, **i32),
        enc_remaining=z(),
        enc_slot=torch.full((B,), -1, **i32),
        switches=z(),
        rc_bank=torch.full((B, p.recode_cap), -1, **i32),
        rc_row=torch.full((B, p.recode_cap), -1, **i32),
        rc_valid=torch.zeros((B, p.recode_cap), dtype=torch.bool, device=dev),
        rq_row=torch.full(nq, -1, **i32),
        rq_age=torch.full(nq, INT32_MAX, **i32),
        rq_valid=torch.zeros(nq, dtype=torch.bool, device=dev),
        wq_row=torch.full(nq, -1, **i32),
        wq_age=torch.full(nq, INT32_MAX, **i32),
        wq_valid=torch.zeros(nq, dtype=torch.bool, device=dev),
        wq_data=torch.zeros(nq, **i32),
        write_mode=torch.zeros((B,), dtype=torch.bool, device=dev),
        cycle=z(),
        banks_data=torch.zeros((B, p.n_data, p.n_rows), **i32),
        parity_data=torch.zeros((B, p.n_parities, n_slot_rows), **i32),
        golden=torch.zeros((B, p.n_data, p.n_rows), **i32),
        served_reads=z(),
        served_writes=z(),
        degraded_reads=z(),
        parked_writes=z(),
        read_latency_sum=wide(),
        write_latency_sum=wide(),
        stall_cycles=wide(),
        rc_dropped=z(),
        tele=(init_telemetries(B, p.n_data, n_cores, p.queue_depth, dev)
              if p.telemetry else None),
        fault=(fault if fault is not None
               else fault_states(p, [None] * B, dev)),
    )
