"""ReCoding unit (paper §IV-D), port of ``repro/core/recoding.py``.

A ring of pending recode requests ``(bank, row)``. Every cycle, after the
pattern builders have claimed their ports, the unit retires up to
``recode_budget`` entries whose required ports are all idle. Retiring the
entry for ``(b, i)`` writes a parked value back to its data bank, recomputes
every stale parity covering ``b`` at row ``i``, and restores
``fresh_loc = 0`` and ``parity_valid``. Entries whose region is uncoded are
dropped.

The JAX version is a cursor walk in a ``lax.while_loop`` of at most
``recode_budget + 1`` trips; each trip evaluates every remaining entry's
work set under the current state, retires the first feasible entry past
the cursor, and drops the moot entries the scan passed on the way. Under
``vmap`` the loop runs until no point's walk goes on, the finished points
masked. Here B points walk lock-step in a Python loop: each point keeps
its cursor on the device and its budget on the host, a trip retires at
most one entry per point (the retirement is a one-hot mask over the
ring, so every write is one scatter for the batch, masked writes landing
on sink entries), and each trip reads one flag per point to the host
(one sync per trip for the batch). The loop stops when no point has both
budget left and a feasible entry. An empty ring does no trip (a trip over
it changes nothing). Bit-identical to the JAX unit, fault blocking
(``down``) included.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.controller import (JTables, add_offset, col,
                                        point_offsets)
from repro_torch.core.state import MemParams, batch_of_one, point_of


class RecodeOut(NamedTuple):
    port_busy: torch.Tensor
    fresh_loc: torch.Tensor
    parity_valid: torch.Tensor
    parked_count: torch.Tensor
    rc_valid: torch.Tensor
    banks_data: torch.Tensor
    parity_data: torch.Tensor
    n_recoded: torch.Tensor


def recode_step(p: MemParams, t: JTables, *args, rs_active=None,
                down=None) -> RecodeOut:
    """One point's recode step (``recode_steps`` on a batch of one)."""
    return point_of(recode_steps(p, t, *batch_of_one(args),
                                 rs_active=rs_active, down=down), 0)


def recode_steps(
    p: MemParams,
    t: JTables,
    port_busy: torch.Tensor,
    fresh_loc: torch.Tensor,
    parity_valid: torch.Tensor,
    parked_count: torch.Tensor,
    rc_bank: torch.Tensor,
    rc_row: torch.Tensor,
    rc_valid: torch.Tensor,
    region_slot: torch.Tensor,
    banks_data: torch.Tensor,
    parity_data: torch.Tensor,
    rs_active=None,
    down=None,
) -> RecodeOut:
    """Retire up to ``recode_budget`` ring entries per point whose ports
    are all idle, for B points (every input has a leading (B,) axis; the
    inputs are not modified).

    ``down`` (B, n_data), fault injection: each point's hard-down data
    banks. A parity recompute that would read a hard-down member is
    blocked (on a parked retire the parity is invalidated instead, as for
    a parked member), and an entry whose own bank is hard-down is moot and
    dropped; the rebuild sweep pushes its cell again once the bank
    recovers."""
    dev = rc_bank.device
    B, cap = rc_valid.shape
    n_recoded = torch.zeros((B,), dtype=torch.int32, device=dev)
    # analysis: host-sync one read a cycle skips the unit when rings are empty
    if p.recode_budget <= 0 or not bool(rc_valid.any()):
        return RecodeOut(port_busy, fresh_loc, parity_valid, parked_count,
                         rc_valid, banks_data, parity_data, n_recoded)
    P = p.n_ports
    nd, R = p.n_data, p.n_rows
    rs = p.region_size
    rs_a = col(rs if rs_active is None else rs_active)
    n_regions = parked_count.shape[1]
    n_pr = parity_data.shape[2]
    n_pd = parity_data[0].numel()
    # every per-point buffer flat with one trailing sink entry, so the
    # masked writes of points that retire nothing (and of padded options)
    # land nowhere
    def flat(x):
        return torch.cat([x.flatten(), x.new_zeros(1)])

    fresh, banks, pd, pv, pc = map(flat, (fresh_loc, banks_data,
                                          parity_data, parity_valid,
                                          parked_count))
    sink_cell, sink_pd, sink_pc = B * nd * R, B * n_pd, B * n_regions
    rc_valid = rc_valid.clone()
    # ports, each point's row with two never-busy sink slots: P (gathered
    # by masked needs) and P + 1 (scattered to by masked claims)
    pb = torch.cat([port_busy[:, :P], port_busy.new_zeros(B, 2)],
                   1).flatten()
    budget = [p.recode_budget] * B             # on the host
    b = rc_bank.long().clamp(min=0)                         # (B, E)
    i = rc_row.long().clamp(min=0)
    region = i // rs_a
    slot = region_slot.gather(1, region).long()
    coded = slot >= 0
    pr = slot.clamp(min=0) * rs + i % rs_a
    optj = t.opt_parity[b]                                  # (B, E, K)
    optjj = optj.clamp(min=0)
    mem = t.par_members[optjj]                              # (B, E, K, 3)
    memc = mem.clamp(min=0)
    mem_ok = mem >= 0
    mem_other = mem_ok & (mem != b[..., None, None])
    opt_code = (optj >= 0) & coded[..., None]
    parked_at = optjj[..., None] + 1
    coff = point_offsets(B, nd * R, dev)
    cell = add_offset(b * R + i, coff)
    mem_cell = add_offset(memc * R + i[..., None, None],
                    None if coff is None else coff[..., None, None])
    reg = add_offset(region, point_offsets(B, n_regions, dev))
    doff = point_offsets(B, n_pd, dev)
    pd_row = add_offset(pr, doff)                                 # + j * n_pr
    pflat = add_offset(optjj * n_pr + pr[..., None],
                 None if doff is None else doff[..., None])
    poff = point_offsets(B, P + 2, dev)
    gsink = torch.full((B, 1, 1), P, dtype=torch.int64, device=dev)
    if poff is not None:
        gsink += poff[..., None]
    b_o = add_offset(b, poff)[..., None]                          # (B, E, 1)
    pport_o = add_offset(t.par_port[optjj], None if poff is None
                   else poff[..., None])                    # (B, E, K)
    memc_o = add_offset(memc, None if poff is None
                  else poff[..., None, None]).flatten(2)    # (B, E, 3K)
    if down is not None:
        # down membership does not change within a cycle
        blocked_f = (mem_other & down.gather(1, memc.flatten(1)).view(
            memc.shape)).any(3)                             # (B, E, K)
        self_down = down.gather(1, b)                       # (B, E)
    epos = torch.arange(cap, device=dev)
    cursor = torch.full((B, 1), -1, dtype=torch.int64, device=dev)
    while any(v > 0 for v in budget):
        # ---- per-entry work set under the current state
        fl = fresh[cell]
        parked = fl > 0
        holder = (fl.long() - 1).clamp(min=0)
        blocked = (mem_other & (fresh[mem_cell] == parked_at)).any(3)
        if down is not None:
            blocked = blocked | blocked_f
        need = opt_code & (~pv[pflat] | parked[..., None])
        recompute = need & ~blocked
        has_work = parked | recompute.any(2)
        if down is not None:
            has_work = has_work & ~self_down
        pending = rc_valid & (epos > cursor)
        work = pending & coded & has_work
        moot = pending & ~(coded & has_work)
        rc_k = recompute & work[..., None]
        hold_o = add_offset(t.par_port[holder], poff)[..., None]
        needed = torch.cat([
            torch.where(work[..., None], b_o, gsink),
            torch.where((work & parked)[..., None], hold_o, gsink),
            torch.where(rc_k, pport_o, gsink),
            torch.where((rc_k[..., None] & mem_ok).flatten(2), memc_o,
                        gsink)], 2)
        tf = work & ~pb[needed].any(2)
        any_tf = tf.any(1, True)                            # (B, 1)
        # analysis: host-sync one read a trip: stop once no point can retire
        found = any_tf[:, 0].tolist()
        if not any(found):
            rc_valid &= ~moot                # every scan ran to its end
            break
        # ---- retire each point's first feasible entry e
        e = tf.int().argmax(1, True)
        hit = (epos == e) & any_tf                          # one-hot
        seg_end = torch.where(any_tf, e, cap)
        rc_valid &= ~((moot & (epos < seg_end)) | hit)
        pb.index_put_((torch.where(hit[..., None] & (needed != gsink),
                                   needed, gsink + 1),),
                      torch.ones((), dtype=torch.bool, device=dev))
        hp = hit & parked
        restored = pd[add_offset(holder * n_pr, pd_row)]
        banks.index_put_((torch.where(hp, cell, sink_cell),), restored)
        pc.index_put_((torch.where(hp, reg, sink_pc),),
                      torch.full((), -1, dtype=pc.dtype, device=dev),
                      accumulate=True)
        fresh.index_put_((torch.where(hit, cell, sink_cell),),
                         torch.zeros((), dtype=fresh.dtype, device=dev))
        do_k = recompute & hit[..., None]                   # (B, E, K)
        inv_k = need & blocked & hp[..., None]
        mv = torch.where(mem_ok, banks[mem_cell], 0)
        val = mv[..., 0] ^ mv[..., 1] ^ mv[..., 2]
        pd.index_put_((torch.where(do_k, pflat, sink_pd),), val)
        pv.index_put_((torch.where(do_k | inv_k, pflat, sink_pd),), do_k)
        n_recoded += any_tf[:, 0]
        cursor = torch.where(any_tf, e, cap)
        for pt, f in enumerate(found):
            budget[pt] = budget[pt] - 1 if f else 0
            if f and budget[pt] == 0 and B > 1:
                cursor[pt] = cap         # out of budget: its walk ends
    return RecodeOut(
        torch.cat([pb.view(B, P + 2)[:, :P], port_busy[:, P:]], 1),
        fresh[:-1].view_as(fresh_loc), pv[:-1].view_as(parity_valid),
        pc[:-1].view_as(parked_count), rc_valid,
        banks[:-1].view_as(banks_data), pd[:-1].view_as(parity_data),
        n_recoded)
