"""The cycle's fault hooks, port of ``repro/faults/inject.py``. All three
run behind ``MemParams.faults``, in cycle order, for B points at once
(every state input has a leading (B,) axis):

1. ``drop_unservable`` — fail-fast semantics: a queued read of a hard-down
   bank whose fresh value is in the bank and that no valid parity option
   can decode, and a write to a hard-down bank with no parity coverage to
   park into, are dropped and counted (``unserved_reads`` /
   ``lost_writes``). A bank whose recovery is scheduled still fails fast
   until it starts rebuilding.
2. Port seeding — a down bank's data port reads busy to both pattern
   builders, and so does a stuttering port (in ``cycle_batch``).
3. ``rebuild_scan`` — online rebuild: while any bank rebuilds, a flat
   cursor sweeps every (bank, row) cell at ``recode_budget`` cells a
   cycle, pushing the cells that are parked elsewhere or have a stale
   covering parity into the recode ring; the bank rejoins (``rebuilt``
   latches) once the sweep is done and no restorable work remains.

JAX pushes the ``recode_budget`` cells one trip at a time. Here one pass
does a point's cells together, with no host read: the cells' ``need``
mask, their prefix count of new entries against the ring's free slots,
and the cursor advanced to the first cell that does not fit. The j-th new
entry takes the j-th free slot, as JAX's first-free-slot pushes do, so
the ring is bit-equal.

This module imports no ``repro_torch.core`` module (the core imports it).
"""
from __future__ import annotations

import torch

from repro_torch.faults.plan import NEVER, FaultState


def _col(x):
    """A per-point geometry value shaped to broadcast over (B, N) tables."""
    return x.view(-1, 1) if isinstance(x, torch.Tensor) else x


def _pv_at(parity_valid, optjj, pr):
    """``parity_valid[b, optjj[b, n, k], pr[b, n]]`` for (B, N, K)
    parity ids and (B, N) parity rows."""
    B, n, K = optjj.shape
    n_pr = parity_valid.shape[2]
    return parity_valid.flatten(1).gather(
        1, (optjj * n_pr + pr[..., None]).flatten(1)).view(B, n, K)


def drop_unservable(p, t, down_hard, rq_row, rq_valid, wq_row, wq_valid,
                    fresh_loc, parity_valid, region_slot, rs_active):
    """Clear the queue slots whose requests are unservable under
    ``down_hard`` (B, n_data). Returns ``(rq_valid, wq_valid, n_unserved,
    n_lost)``, the counts (B,) int32. A pure per-slot predicate."""
    B = rq_row.shape[0]
    dev = rq_row.device
    nd, R, dq = p.n_data, p.n_rows, p.queue_depth
    rs = p.region_size
    rs_a = _col(rs_active)
    cb = torch.arange(nd, device=dev).repeat_interleave(dq)     # (N,)
    dh = down_hard[:, cb]                                       # (B, N)

    i = rq_row.flatten(1).long().clamp(min=0)
    slot = region_slot.gather(1, i // rs_a).long()
    coded = slot >= 0
    pr = slot.clamp(min=0) * rs + i % rs_a
    optj = t.opt_parity[cb].expand(B, -1, -1)                   # (B, N, K)
    optjj = optj.clamp(min=0)
    opt_ok = (optj >= 0) & coded[..., None] & _pv_at(parity_valid, optjj, pr)
    sibs = t.opt_sibs[cb]                                       # (N, K, S)
    sib_dead = ((sibs >= 0) & down_hard[:, sibs.clamp(min=0)]).any(-1)
    viable = opt_ok & ~sib_dead
    fl = fresh_loc.flatten(1).gather(1, cb * R + i)
    drop_r = (rq_valid.flatten(1) & dh & (fl == 0) & ~viable.any(-1))

    wi = wq_row.flatten(1).long().clamp(min=0)
    w_coded = region_slot.gather(1, wi // rs_a) >= 0
    drop_w = wq_valid.flatten(1) & dh & (~w_coded | (t.opt_n[cb] == 0))
    return (rq_valid & ~drop_r.view_as(rq_valid),
            wq_valid & ~drop_w.view_as(wq_valid),
            drop_r.sum(1, dtype=torch.int32),
            drop_w.sum(1, dtype=torch.int32))


def rebuild_scan(p, t, fault: FaultState, cycle, rebuilding, down_hard,
                 fresh_loc, parity_valid, region_slot, rc_bank, rc_row,
                 rc_valid, rs_active, nr_active):
    """Advance each point's online-rebuild sweep and latch ``rebuilt`` on
    completion. Returns ``(rc_bank, rc_row, rc_valid, fault)``.

    Runs after the ReCoding unit. The cursor walks cells ``0 ..
    n_data * n_rows`` at ``recode_budget`` cells a cycle and resets to 0
    whenever a bank's recovery begins. A cell is pushed when its fresh
    value is parked elsewhere or a covering parity is stale; a push that
    finds the ring full stalls the cursor there. Cells outside the point's
    active geometry are skipped. Completion needs the sweep done, the
    ring drained and no parked cell left on a bank that is not hard-down.
    """
    B = cycle.shape[0]
    dev = cycle.device
    nd, R = p.n_data, p.n_rows
    total = nd * R
    rs = p.region_size
    rs_a, nr_a = _col(rs_active), _col(nr_active)
    cap = rc_valid.shape[1]
    cyc = cycle[:, None]
    any_rb = rebuilding.any(1, keepdim=True)                    # (B, 1)
    newly = ((fault.recover_at == cyc) & (fault.fail_at <= cyc)
             & ~fault.rebuilt).any(1)
    ptr0 = torch.where(newly, 0, fault.rebuild_ptr).long()      # (B,)

    # the budget's cells, in cursor order
    ptr = ptr0[:, None] + torch.arange(p.recode_budget, device=dev)
    in_range = any_rb & (ptr < total)
    cell = ptr.clamp(max=total - 1)
    x = cell // R
    i = cell % R
    region = i // rs_a
    in_geom = region < nr_a
    slot = region_slot.gather(
        1, region.clamp(max=region_slot.shape[1] - 1)).long()
    coded = slot >= 0
    pr = slot.clamp(min=0) * rs + i % rs_a
    optj = t.opt_parity[x]                                      # (B, C, K)
    stale = ((optj >= 0) & coded[..., None]
             & ~_pv_at(parity_valid, optj.clamp(min=0), pr)).any(-1)
    fl = fresh_loc.flatten(1).gather(1, cell)
    need = in_range & in_geom & ((fl > 0) | stale)

    # a cell already in the ring needs no slot; the others take the free
    # slots in order, and the first one without a slot stalls the cursor
    x32, i32 = x.int(), i.int()
    dup = (rc_valid[:, None] & (rc_bank[:, None] == x32[..., None])
           & (rc_row[:, None] == i32[..., None])).any(-1)
    new = need & ~dup
    rank = new.long().cumsum(1) - new.long()                    # exclusive
    free = ~rc_valid
    stall = new & (rank >= free.sum(1, keepdim=True))
    go = in_range & (stall.long().cumsum(1) == 0)               # a prefix
    ins = go & new
    free_rank = free.long().cumsum(1) - 1
    slot_of = torch.full((B, cap + 1), cap, dtype=torch.int64, device=dev)
    slot_of.scatter_(1, torch.where(free, free_rank, cap),
                     torch.arange(cap, device=dev).expand(B, cap))
    at = torch.where(ins, slot_of.gather(1, rank.clamp(max=cap)), cap)
    ring_b = torch.cat([rc_bank, rc_bank.new_zeros(B, 1)], 1)
    ring_r = torch.cat([rc_row, rc_row.new_zeros(B, 1)], 1)
    ring_v = torch.cat([rc_valid, rc_valid.new_zeros(B, 1)], 1)
    ring_b.scatter_(1, at, x32)
    ring_r.scatter_(1, at, i32)
    ring_v.scatter_(1, at, True)
    rc_bank, rc_row, rc_valid = (ring_b[:, :cap], ring_r[:, :cap],
                                 ring_v[:, :cap])
    ptr_new = ptr0 + go.sum(1)

    pending_park = ((fresh_loc > 0).any(2) & ~down_hard).any(1)
    complete = (ptr_new >= total) & ~rc_valid.any(1) & ~pending_park
    rebuilt = fault.rebuilt | (rebuilding & complete[:, None])
    return rc_bank, rc_row, rc_valid, fault._replace(
        rebuilt=rebuilt, rebuild_ptr=ptr_new.int())


def quiescent_fault_pending(fault: FaultState, cycle) -> torch.Tensor:
    """True while a scheduled fault event can still change observable
    state: an un-failed bank with a failure pending, or a failed bank with
    a recovery scheduled (its rebuild must finish first). One point's 0-d
    flag, or (B,) for a batch."""
    cyc = cycle[..., None]
    down = (fault.fail_at <= cyc) & ~fault.rebuilt
    pending = (((fault.fail_at > cyc) & (fault.fail_at < NEVER))
               | (down & (fault.recover_at < NEVER)))
    return pending.any(-1)
