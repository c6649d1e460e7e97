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

The unit runs B points lock-step. Their control scalars (cycle, encoder
state, the drained flag and the tunables the unit reads) are read to the
host once per call, for the whole batch, and only the work a cycle
actually has is issued: the region encodes run only on a cycle an encode
completes, the encodes of every point completing that cycle through one
``xor_encode`` launch on the card, and a selection reads its candidates
once for the batch. JAX evaluates every branch every cycle and selects;
the results are identical.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.core.controller import JTables, col
from repro_torch.core.state import (INT32_MAX, MemParams, TunableParams,
                                    active_geometry, active_ints)
from repro_torch.kernels.xor_encode.ops import encode_regions


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


def priors_layout(p: MemParams, tn, priors):
    """(region_slot, slot_region, parity_valid) of one point as numpy
    arrays, pre-mapping profiled hot regions into parity slots: the warm
    start ``init_states`` applies with ``region_priors``.

    ``priors`` (array, list or tensor) is a ranked array of distinct
    region ids, hottest first, -1 padded
    (``repro_torch.traces.TraceProfile.region_priors`` emits one). The
    leading entries fill parity slots 0.. up to the point's slot budget;
    ids outside its active regions and -1 padding are skipped without
    shifting later entries. The mapped slots' parity rows are valid: every
    data bank is zero at init, so the all-zero parity rows are their
    members' XOR. ``tn`` is the point's python-int tunables (or None).
    Built on the host (a few hundred cells, once), as JAX's ``.at[].set``
    scatters it."""
    rs = p.region_size
    rs_a, nr_a = active_ints(p, tn)
    budget = p.n_active if tn is None else min(int(tn.n_slots_active),
                                                 p.n_active)
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
    return region_slot[:-1], slot_region, np.ascontiguousarray(parity_valid)


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
    """One cycle of the unit for B points: every state input has a leading
    (B,) axis and ``tn`` is batched (the inputs are not modified)."""
    if p.n_active >= p.n_regions:  # static full coverage: unit disabled
        return DynOut(region_slot, slot_region, access_count, parity_valid,
                      parity_data, enc_region, enc_remaining, enc_slot,
                      switches)
    rs = p.region_size
    _, nr_a = active_geometry(p, tn)
    dev = region_slot.device
    q = torch.zeros_like(cycle) if quiesce is None else quiesce.int()
    # analysis: host-sync one read a cycle: each point's encoder and period
    host = torch.stack([cycle, enc_region, enc_remaining, enc_slot, q,
                        tn.select_period, tn.region_size_active]).T.tolist()
    enc = [h[1:4] for h in host]                 # (er, erem, es) per point
    state = [list(e) for e in enc]
    done, period, select = [], [], []
    for b, (cyc, er, erem, es, quiet, sp, rsa) in enumerate(host):
        rs_a = min(rsa, rs) if p.traced_geometry else rs
        # ---- encode in flight
        in_flight = er >= 0
        erem = erem - 1 if in_flight else 0
        if in_flight and erem <= 0:
            done.append((b, er, es, rs_a))
            er = es = -1
        # ---- periodic selection (none once the workload has drained)
        period.append(cyc % sp == 0 and cyc > 0)
        if period[-1] and er < 0 and not quiet:
            select.append((b, rs_a))
        state[b] = [er, erem, es]
    cloned = bool(done)
    if done:
        # completion: write the parity data, validate rows, install mapping
        parity_data = encode_regions(p, t, banks_data, parity_data, done)
        parity_valid = parity_valid.clone()
        region_slot = region_slot.clone()
        slot_region = slot_region.clone()
        switches = switches.clone()
        off = torch.arange(rs, device=dev)
        for b, er, es, rs_a in done:
            s0 = max(es, 0) * rs
            parity_valid[b, :, s0:s0 + rs] |= off < rs_a
            region_slot[b, max(er, 0)] = es
            slot_region[b, max(es, 0)] = er
            switches[b] += 1
    if select:
        coded = region_slot >= 0
        region_active = torch.arange(p.n_regions, device=dev) < col(nr_a)
        cand_counts = torch.where(coded | ~region_active, -1, access_count)
        cand = cand_counts.argmax(1, True)
        evict_counts = torch.where(coded & (parked_count == 0), access_count,
                                   INT32_MAX)
        victim = evict_counts.argmin(1, True)
        budget = tn.n_slots_active.clamp(max=p.n_active)[:, None]
        free_mask = (slot_region < 0) & (
            torch.arange(p.n_slots, device=dev) < budget)
        # analysis: host-sync a selecting cycle's candidates and victims
        rows = torch.cat([
            cand, cand_counts.gather(1, cand).long(), victim,
            evict_counts.gather(1, victim).long(),
            free_mask.any(1, True).long(), free_mask.int().argmax(1, True),
            region_slot.gather(1, victim).long()], 1).tolist()
        for b, rs_a in select:
            (cand_b, cand_count, victim_b, victim_count, has_free,
             free_slot, vslot) = rows[b]
            start_free = has_free and cand_count > 0
            start_evict = (not has_free and cand_count > victim_count
                           and victim_count < INT32_MAX)
            vslot = max(vslot, 0)
            if start_evict:
                # clear the victim's slot and validity (whole allocated
                # stride)
                if not cloned:
                    parity_valid = parity_valid.clone()
                    region_slot = region_slot.clone()
                    slot_region = slot_region.clone()
                    cloned = True
                parity_valid[b, :, vslot * rs:vslot * rs + rs] = False
                region_slot[b, victim_b] = -1
                slot_region[b, vslot] = -1
            if start_free or start_evict:
                state[b] = [cand_b, max(1, rs_a // p.encode_rows_per_cycle),
                            vslot if start_evict else free_slot]
    if any(period):
        # windowed counts decay
        if all(period):
            access_count = access_count // 2
        else:
            per = _to_device(period, torch.bool, dev)
            access_count = torch.where(per[:, None], access_count // 2,
                                       access_count)
    if state != enc:
        cols = [_ints([s[k] for s in state], dev) for k in range(3)]
        enc_region, enc_remaining, enc_slot = cols
    return DynOut(region_slot, slot_region, access_count, parity_valid,
                  parity_data, enc_region, enc_remaining, enc_slot, switches)


def _ints(values: List[int], device) -> torch.Tensor:
    """(B,) int32 tensor of host ints on ``device``: a fill when they are
    all equal, else one copy."""
    if all(v == values[0] for v in values):
        return torch.full((len(values),), values[0], dtype=torch.int32,
                          device=device)
    return _to_device(values, torch.int32, device)


def _to_device(values, dtype, device) -> torch.Tensor:
    """Host values as a tensor on ``device``; on the card an asynchronous
    copy from pinned memory (a plain copy would synchronise the stream)."""
    host = torch.tensor(values, dtype=dtype)
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)
