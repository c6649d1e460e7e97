"""Dynamic coding unit (paper §IV-E), port of ``repro/core/dynamic.py``.

Rows form ``n_regions`` regions of ``region_size`` rows; the parity banks
hold ``n_slots = ⌊α/r⌋`` coded regions (at α = 1 everything is coded
statically and the unit is a no-op). Every ``select_period`` cycles the
hottest uncoded region (windowed access count) is encoded into a free
slot, or replaces the coldest coded region without parked rows when it is
strictly hotter. An encode takes ``max(1, rs // encode_rows_per_cycle)``
cycles; its completion writes the region's parities (the XOR of member
data banks), validates them and counts one switch. Counts halve each
period.

The unit's control scalars (cycle, encoder state, the drained flag) are
read to the host once per call, and only the work a cycle actually has is
issued: the region encode runs only on the cycle an encode completes, on
the card through the CUDA ``xor_encode`` kernel. JAX evaluates every
branch every cycle and selects; the results are identical.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.controller import JTables
from repro_torch.core.state import (INT32_MAX, MemParams, TunableParams,
                                    active_geometry)
from repro_torch.kernels.xor_encode.ops import encode_parities


class DynOut(NamedTuple):
    region_slot: torch.Tensor
    slot_region: torch.Tensor
    access_count: torch.Tensor
    parity_valid: torch.Tensor
    parity_data: torch.Tensor
    enc_region: torch.Tensor
    enc_remaining: torch.Tensor
    enc_slot: torch.Tensor
    switches: torch.Tensor


def _encode_region_data(p: MemParams, t: JTables, banks_data: torch.Tensor,
                        parity_data: torch.Tensor, region: int, slot: int,
                        rs_a: int) -> torch.Tensor:
    """``parity_data`` with ``slot``'s rows set to the XOR parities of
    ``region``'s rows (a new tensor). The rows are gathered with the clamped
    indices of ``repro/core/dynamic.py:63``; lanes at offsets ≥ ``rs_a``
    write 0."""
    rs = p.region_size
    dev = banks_data.device
    off = torch.arange(rs, device=dev)
    rows = (int(region) * rs_a + off).clamp(0, p.n_rows - 1)
    region_rows = banks_data[:, rows][..., None]            # (n_data, rs, 1)
    vals = encode_parities(region_rows, t.par_members)[..., 0]
    vals = torch.where(off < rs_a, vals, 0)
    # dynamic_update_slice clamps the start so the slice fits
    start = min(max(int(slot), 0) * rs, parity_data.shape[1] - rs)
    out = parity_data.clone()
    out[:, start:start + rs] = vals
    return out


def priors_layout(p: MemParams, tn, priors, device):
    """(region_slot, slot_region, parity_valid) on ``device``, pre-mapping
    profiled hot regions into parity slots: the warm start ``init_state``
    applies with ``region_priors``.

    ``priors`` (array, list or tensor) is a ranked array of distinct
    region ids, hottest first, -1 padded
    (``repro_torch.traces.TraceProfile.region_priors`` emits one). The
    leading entries fill parity slots 0.. up to the slot budget; ids
    outside the active regions and -1 padding are skipped without shifting
    later entries. The mapped slots' parity rows are valid: every data
    bank is zero at init, so the all-zero parity rows are their members'
    XOR. Built on the host (a few hundred cells, once), as JAX's
    ``.at[].set`` scatters it, then moved to ``device``."""
    rs = p.region_size
    if tn is None:
        rs_a, nr_a = p.region_size, p.n_regions
        budget = p.n_active
    else:
        rs_a, nr_a = active_geometry(p, tn)
        budget = min(int(tn.n_slots_active), p.n_active)
    if isinstance(priors, torch.Tensor):
        priors = priors.cpu().numpy()
    pr = np.asarray(priors).astype(np.int32).reshape(-1)
    cand = np.full(p.n_slots, -1, np.int32)       # slot s takes entry s
    cand[:min(pr.size, p.n_slots)] = pr[:p.n_slots]
    ok = (np.arange(p.n_slots) < budget) & (cand >= 0) & (cand < nr_a)
    slot_region = np.where(ok, cand, -1).astype(np.int32)
    region_slot = np.full(p.n_regions + 1, -1, np.int32)       # + a sink
    region_slot[np.where(ok, cand, p.n_regions)] = np.arange(p.n_slots)
    # parity rows are stored at the allocated stride (slot * rs +
    # i % rs_active): this walks that storage layout
    row = np.arange(p.n_slots * rs)
    active = ok[row // rs] & (row % rs < rs_a)
    parity_valid = np.broadcast_to(active, (p.n_parities, row.size))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (region_slot[:-1], slot_region, parity_valid))


def dynamic_step(
    p: MemParams,
    t: JTables,
    tn: TunableParams,
    cycle: torch.Tensor,
    region_slot: torch.Tensor,
    slot_region: torch.Tensor,
    access_count: torch.Tensor,
    parked_count: torch.Tensor,
    parity_valid: torch.Tensor,
    parity_data: torch.Tensor,
    banks_data: torch.Tensor,
    enc_region: torch.Tensor,
    enc_remaining: torch.Tensor,
    enc_slot: torch.Tensor,
    switches: torch.Tensor,
    quiesce=None,
) -> DynOut:
    if p.n_active >= p.n_regions:  # static full coverage: unit disabled
        return DynOut(region_slot, slot_region, access_count, parity_valid,
                      parity_data, enc_region, enc_remaining, enc_slot,
                      switches)
    rs = p.region_size
    rs_a, nr_a = active_geometry(p, tn)
    dev = region_slot.device
    no_q = torch.zeros((), dtype=torch.bool, device=dev)
    cyc, er, erem, es, q = torch.stack([
        cycle.long(), enc_region.long(), enc_remaining.long(),
        enc_slot.long(), (no_q if quiesce is None else quiesce).long()
    ]).tolist()

    # ---- encode in flight
    in_flight = er >= 0
    erem = erem - 1 if in_flight else 0
    if in_flight and erem <= 0:
        # completion: write the parity data, validate rows, install mapping
        parity_data = _encode_region_data(p, t, banks_data, parity_data, er,
                                          es, rs_a)
        s0 = max(es, 0) * rs
        parity_valid = parity_valid.clone()
        parity_valid[:, s0:s0 + rs] |= torch.arange(rs, device=dev) < rs_a
        region_slot = region_slot.clone()
        slot_region = slot_region.clone()
        region_slot[max(er, 0)] = es
        slot_region[max(es, 0)] = er
        switches = switches + 1
        er = es = -1

    # ---- periodic selection (none once the workload has drained)
    period = cyc % tn.select_period == 0 and cyc > 0
    if period and er < 0 and not q:
        coded = region_slot >= 0
        region_active = torch.arange(p.n_regions, device=dev) < nr_a
        cand_counts = torch.where(coded | ~region_active, -1, access_count)
        cand = cand_counts.argmax(0, True)
        evict_counts = torch.where(coded & (parked_count == 0), access_count,
                                   INT32_MAX)
        victim = evict_counts.argmin(0, True)
        budget = min(tn.n_slots_active, p.n_active)
        free_mask = (slot_region < 0) & (
            torch.arange(p.n_slots, device=dev) < budget)
        (cand, cand_count, victim, victim_count, has_free, free_slot,
         vslot) = torch.cat([
             cand, cand_counts[cand].long(), victim,
             evict_counts[victim].long(), free_mask.any().long().view(1),
             free_mask.int().argmax(0, True), region_slot[victim].long()
         ]).tolist()
        start_free = has_free and cand_count > 0
        start_evict = (not has_free and cand_count > victim_count
                       and victim_count < INT32_MAX)
        vslot = max(vslot, 0)
        if start_evict:
            # clear the victim's slot and validity (whole allocated stride)
            parity_valid = parity_valid.clone()
            parity_valid[:, vslot * rs:vslot * rs + rs] = False
            region_slot = region_slot.clone()
            slot_region = slot_region.clone()
            region_slot[victim] = -1
            slot_region[vslot] = -1
        if start_free or start_evict:
            er = cand
            es = vslot if start_evict else free_slot
            erem = max(1, rs_a // p.encode_rows_per_cycle)
    if period:
        access_count = access_count // 2      # windowed counts decay

    def scalar(v):
        return torch.full((), v, dtype=torch.int32, device=dev)

    return DynOut(region_slot, slot_region, access_count, parity_valid,
                  parity_data, scalar(er), scalar(erem), scalar(es), switches)
