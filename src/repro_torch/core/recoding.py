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
the cursor, and drops the moot entries the scan passed on the way. Here the
same trips run in a Python loop: each trip reads one flag and the retired
entry's position to the host (a sync per trip, at most ``budget + 1``), so
the retirement itself indexes with python ints. An empty ring does no trip
(a trip over it changes nothing). Bit-identical to the JAX unit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.codes import MAX_SIBS
from repro_torch.core.controller import JTables
from repro_torch.core.state import MemParams


class RecodeOut(NamedTuple):
    port_busy: torch.Tensor
    fresh_loc: torch.Tensor
    parity_valid: torch.Tensor
    parked_count: torch.Tensor
    rc_valid: torch.Tensor
    banks_data: torch.Tensor
    parity_data: torch.Tensor
    n_recoded: torch.Tensor


def recode_step(
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
    rs_active: Optional[int] = None,
    down=None,
) -> RecodeOut:
    """Retire up to ``recode_budget`` ring entries whose ports are all idle
    (the inputs are not modified)."""
    if down is not None:
        raise NotImplementedError("fault injection (down banks) is not "
                                  "ported yet")
    dev = rc_bank.device
    P = p.n_ports
    rs = p.region_size
    rs_a = rs if rs_active is None else int(rs_active)
    cap = rc_valid.shape[0]
    fresh_loc = fresh_loc.clone()
    parked_count = parked_count.clone()
    rc_valid = rc_valid.clone()
    banks_data = banks_data.clone()
    # parity rows as flat buffers with one trailing sink entry, so masked
    # writes of a retirement's padded options land nowhere
    n_pr = parity_data.shape[1]
    pd = torch.cat([parity_data.flatten(), parity_data.new_zeros(1)])
    pv = torch.cat([parity_valid.flatten(), parity_valid.new_zeros(1)])
    sink = pd.shape[0] - 1
    parity_data = pd[:-1].view_as(parity_data)
    parity_valid = pv[:-1].view_as(parity_valid)
    # ports with two never-busy sink slots: P (gathered by masked needs)
    # and P + 1 (scattered to by masked claims)
    pb = torch.cat([port_busy[:P], torch.zeros((2,), dtype=torch.bool,
                                               device=dev)])
    budget = p.recode_budget
    if budget > 0 and bool(rc_valid.any()):
        b = rc_bank.long().clamp(min=0)                         # (E,)
        i = rc_row.long().clamp(min=0)
        region = i // rs_a
        slot = region_slot[region].long()
        coded = slot >= 0
        pr = slot.clamp(min=0) * rs + i % rs_a
        optj = t.opt_parity[b]                                  # (E, K)
        optjj = optj.clamp(min=0)
        opt_pport = t.par_port[optjj]
        mem = t.par_members[optjj]                              # (E, K, 3)
        memc = mem.clamp(min=0)
        mem_other = (mem >= 0) & (mem != b[:, None, None])
        opt_code = (optj >= 0) & coded[:, None]
        pflat = optjj * n_pr + pr[:, None]                      # (E, K)
        epos = torch.arange(cap, device=dev)
        # the ring's coordinates drive the retirement's scalar indexing
        host = torch.stack([b, i, region]).tolist()
        cursor = -1
        while budget > 0 and cursor < cap:
            # ---- per-entry work set under the current state
            fl = fresh_loc[b, i]
            parked = fl > 0
            holder = (fl.long() - 1).clamp(min=0)
            blocked = (mem_other & (fresh_loc[memc, i[:, None, None]]
                                    == optjj[:, :, None] + 1)).any(2)
            need = opt_code & (~parity_valid[optjj, pr[:, None]]
                               | parked[:, None])
            recompute = need & ~blocked
            has_work = parked | recompute.any(1)
            pending = rc_valid & (epos > cursor)
            work = pending & coded & has_work
            moot = pending & ~(coded & has_work)
            rc_k = recompute & work[:, None]
            needed_idx = torch.cat([
                torch.where(work, b, P)[:, None],
                torch.where(work & parked, t.par_port[holder], P)[:, None],
                torch.where(rc_k, opt_pport, P),
                torch.where(rc_k[:, :, None] & (mem >= 0), memc,
                            P).flatten(1)], 1)
            tf = work & ~pb[needed_idx].any(1)
            first = tf.int().argmax(0, True)     # first feasible (0 if none)
            any_tf, e, e_parked = torch.cat([
                tf.any().long().view(1), first, parked[first].long()]).tolist()
            if not any_tf:
                rc_valid &= ~moot                # the scan ran to the end
                break
            # ---- retire entry e
            rc_valid &= ~(moot & (epos < e))
            rc_valid[e] = False
            idxs = needed_idx[e]
            pb.index_put_((torch.where(idxs < P, idxs, P + 1),),
                          torch.ones((), dtype=torch.bool, device=dev))
            eb, ei, ereg = host[0][e], host[1][e], host[2][e]
            if e_parked:
                banks_data[eb, ei] = pd[holder[e:e + 1] * n_pr + pr[e:e + 1]][0]
                parked_count[ereg] -= 1
            fresh_loc[eb, ei] = 0
            do_k = recompute[e]                                 # (K,)
            inv_k = need[e] & blocked[e] & bool(e_parked)
            val = torch.zeros(do_k.shape, dtype=torch.int32, device=dev)
            for mm in range(MAX_SIBS + 1):
                val ^= torch.where(mem[e, :, mm] >= 0,
                                   banks_data[memc[e, :, mm], ei], 0)
            pd.index_put_((torch.where(do_k, pflat[e], sink),), val)
            pv.index_put_((torch.where(do_k | inv_k, pflat[e], sink),), do_k)
            cursor = e
            budget -= 1
    port_busy = torch.cat([pb[:P], port_busy[P:]])
    return RecodeOut(port_busy, fresh_loc, parity_valid, parked_count,
                     rc_valid, banks_data, parity_data,
                     torch.tensor(p.recode_budget - budget, dtype=torch.int32,
                                  device=dev))
