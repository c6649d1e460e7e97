"""Read/write pattern builders (paper §IV-B, §IV-C), port of
``repro/core/controller.py``.

Both builders are greedy matchers: candidates are visited oldest first
(a stable age sort, invalid slots keyed to +inf) and each takes the
cheapest feasible serving action this cycle. The semantics, scores and
tie-breaks are the JAX builders' line for line; plans are bit-identical.

Read actions (score): FROM_SYM (0), DIRECT (3), OPT(k) (2 · banks used),
REDIRECT (2). Write actions: DIRECT (1), PARK(k) (2 + k).

How the walk runs in eager PyTorch. JAX walks with a ``lax.while_loop``
of ``n_trips = last valid position + 1`` trips. Here the trip count is
read to the host once per walk (one sync; the write walk reads its
candidates' (bank, row) in the same read, to address its scalar state),
and the loop runs exactly that many trips; invalid candidates would be
no-ops, so nothing else changes. Everything loop-invariant is gathered
once, in walk order, so trip ``k`` reads row ``k`` of each table as a
view, and each action's effects (ports, symbols, freshness, recode
request, invalidations) sit in per-candidate tables picked by the chosen
action. Nothing is indexed with a 0-d tensor (that would call ``.item()``
and sync the card each time). The read walk keeps the port claims and the
chained-decode symbol bit-matrix in one flat bool buffer (ports first,
then symbols), so a trip reads with one gather and claims with one
scatter; masked claims land on the port sink slot ``n_ports``, which JAX
marks busy after every walk anyway.

Index tables are int64 here (torch indexes with int64); plan outputs keep
the JAX dtypes (int32 modes, bool masks).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.codes import MAX_OPTS, CodeTables
from repro_torch.core.state import INT32_MAX, MemParams

INF_SCORE = 1 << 30

# read modes (reported per candidate)
MODE_UNSERVED = -1
MODE_FROM_SYM = 0
MODE_DIRECT = 1
MODE_OPT0 = 2                      # MODE_OPT0 + k  for option k
MODE_REDIRECT = MODE_OPT0 + MAX_OPTS

# write modes
WMODE_UNSERVED = -1
WMODE_DIRECT = 0
WMODE_PARK0 = 1                    # WMODE_PARK0 + k


class JTables(NamedTuple):
    """Device copies of the static code tables (int64)."""

    par_members: torch.Tensor   # (n_par, MAX_SIBS+1)
    par_port: torch.Tensor      # (n_par,)
    opt_parity: torch.Tensor    # (n_data, MAX_OPTS)
    opt_sibs: torch.Tensor      # (n_data, MAX_OPTS, MAX_SIBS)
    opt_n: torch.Tensor         # (n_data,)


def jtables(tables: CodeTables, device="cpu") -> JTables:
    def dev(a):
        return torch.as_tensor(a, dtype=torch.int64).to(device)

    return JTables(par_members=dev(tables.par_members),
                   par_port=dev(tables.par_port),
                   opt_parity=dev(tables.opt_parity),
                   opt_sibs=dev(tables.opt_sibs),
                   opt_n=dev(tables.opt_n))


class ReadPlan(NamedTuple):
    served: torch.Tensor      # (N,) bool
    mode: torch.Tensor        # (N,) int32
    port_busy: torch.Tensor   # (n_ports+1,) bool (updated)
    n_served: torch.Tensor    # () int32
    n_degraded: torch.Tensor  # () int32 — served via parity/symbol reuse


class WritePlan(NamedTuple):
    served: torch.Tensor
    mode: torch.Tensor
    port_busy: torch.Tensor
    fresh_loc: torch.Tensor
    parity_valid: torch.Tensor
    parked_count: torch.Tensor
    rc_bank: torch.Tensor
    rc_row: torch.Tensor
    rc_valid: torch.Tensor
    n_served: torch.Tensor
    n_parked: torch.Tensor
    n_rc_dropped: torch.Tensor


def _walk_bounds(cand_age: torch.Tensor, cand_valid: torch.Tensor):
    """Stable age order (invalid slots last) and the trip bound covering
    every valid candidate, as a 0-d tensor."""
    n = cand_age.shape[0]
    order = torch.argsort(torch.where(cand_valid, cand_age, INT32_MAX),
                          stable=True)
    pos = torch.arange(n, dtype=torch.int32, device=cand_age.device)
    last = torch.where(cand_valid[order], pos, -1).max()
    return order, last + 1


def _plan_counts(served: torch.Tensor, sel: torch.Tensor):
    return (served.sum(dtype=torch.int32),
            (served & sel).sum(dtype=torch.int32))


def build_read_pattern(
    p: MemParams,
    t: JTables,
    cand_bank: torch.Tensor,
    cand_row: torch.Tensor,
    cand_age: torch.Tensor,
    cand_valid: torch.Tensor,
    port_busy: torch.Tensor,
    fresh_loc: torch.Tensor,
    parity_valid: torch.Tensor,
    region_slot: torch.Tensor,
    rs_active: Optional[int] = None,
) -> ReadPlan:
    dev = cand_bank.device
    n = cand_bank.shape[0]
    K = MAX_OPTS
    P = p.n_ports
    R = p.n_rows
    rs = p.region_size
    rs_a = rs if rs_active is None else int(rs_active)
    order, n_trips = _walk_bounds(cand_age, cand_valid)
    n_trips = int(n_trips)                     # one host read per walk

    served = torch.zeros((n,), dtype=torch.bool, device=dev)
    mode = torch.full((n,), MODE_UNSERVED, dtype=torch.int32, device=dev)
    so = P + 1                                 # symbols follow the ports
    busy = torch.cat([port_busy, torch.zeros((p.n_data * R,),
                                             dtype=torch.bool, device=dev)])
    if n_trips > 0:
        # ---- per-candidate tables in walk order, gathered once
        oc = order[:n_trips]
        b = cand_bank[oc].long().clamp(min=0)
        i = cand_row[oc].long().clamp(min=0)
        valid = cand_valid[oc]
        fl = fresh_loc[b, i].long()
        slot = region_slot[i // rs_a].long()
        coded = slot >= 0
        pr = slot.clamp(min=0) * rs + i % rs_a
        hold_port = t.par_port[(fl - 1).clamp(min=0)]
        # a scheme with no parities points the REDIRECT claim at the sink
        hold_idx = torch.where(hold_port < 0, P, hold_port)
        optj = t.opt_parity[b]                                  # (T, K)
        optjj = optj.clamp(min=0)
        opt_pv = (optj >= 0) & coded[:, None] & parity_valid[optjj, pr[:, None]]
        opt_pport = t.par_port[optjj]
        opt_pport = torch.where(opt_pport < 0, P, opt_pport)
        sibs = t.opt_sibs[b].transpose(1, 2)                    # (T, 2, K)
        has = sibs >= 0
        sib = sibs.clamp(min=0)
        may_serve = valid & (fl == 0)
        can_rd = valid & (fl > 0)
        opt_may = may_serve[:, None] & opt_pv
        sym_b = so + b * R + i
        sym_s = so + sib * R + i[:, None, None]                 # (T, 2, K)
        # gather row: [sym b, port b, port hold, K parity ports,
        #              2K sibling ports, 2K sibling symbols]
        gidx = torch.cat([sym_b[:, None], b[:, None], hold_idx[:, None],
                          opt_pport, sib.flatten(1), sym_s.flatten(1)], 1)
        # the three scalar actions (FROM_SYM, DIRECT, REDIRECT) are feasible
        # where the gathered bit differs from ``inv3``
        base3 = torch.stack([may_serve & bool(p.coalesce), may_serve,
                             can_rd], 1)
        inv3 = torch.tensor([False, True, True], device=dev)
        score3 = torch.tensor([0, 3, 2], device=dev)
        # claims of each action a: [port, sym b, sym sib0, sym sib1];
        # sibling ports are claimed only where the symbol is not yet held
        sink = torch.full_like(b, P)
        sym_sib = torch.where(has, sym_s, P)                    # (T, 2, K)
        claims = torch.cat([
            torch.stack([sink, sink, sink, sink], 1)[:, None],            # sym
            torch.stack([b, sym_b, sink, sink], 1)[:, None],              # dir
            torch.stack([opt_pport, sym_b[:, None].expand(-1, K),
                         sym_sib[:, 0], sym_sib[:, 1]], 2),               # opt
            torch.stack([hold_idx, sink, sink, sink], 1)[:, None],        # rd
        ], 1)                                                    # (T, A, 4)
        pad2 = torch.full((2, 2), P, dtype=torch.int64, device=dev)
        pad1 = torch.full((2, 1), P, dtype=torch.int64, device=dev)
        vals, acts = [], []
        for k in range(n_trips):
            g = busy[gidx[k]]
            pb_s = g[3 + K:3 + 3 * K].view(2, K)
            sy_s = g[3 + 3 * K:].view(2, K)
            need = has[k] & ~sy_s                               # (2, K)
            blocked = (need & pb_s).any(0)
            feas = opt_may[k] & ~(g[3:3 + K] | blocked)
            opt_sc = torch.where(feas, need.sum(0) * 2 + 2, INF_SCORE)
            sc3 = torch.where(base3[k] & (g[0:3] != inv3), score3, INF_SCORE)
            val, act = torch.cat([sc3[:2], opt_sc, sc3[2:]]).min(0, True)
            sports = torch.cat([pad2, torch.where(need, sib[k], P), pad1], 1)
            upd = torch.cat([claims[k], sports.T], 1)           # (A, 6)
            busy.index_fill_(0, upd[act].flatten(), True)
            vals.append(val)
            acts.append(act)
        found = torch.cat(vals) < INF_SCORE
        served.index_put_((oc,), found)
        mode.index_put_((oc,), torch.where(found, torch.cat(acts),
                                           MODE_UNSERVED).int())
    port_busy = busy[:P + 1].clone()
    # the masked no-op claims land on the sink slot; mark it busy even when
    # the walk reaches no valid candidate, as JAX does
    port_busy[P] = True
    n_served, n_degraded = _plan_counts(
        served, (mode == MODE_FROM_SYM)
        | ((mode >= MODE_OPT0) & (mode < MODE_REDIRECT)))
    return ReadPlan(served, mode, port_busy, n_served, n_degraded)


def build_write_pattern(
    p: MemParams,
    t: JTables,
    cand_bank: torch.Tensor,
    cand_row: torch.Tensor,
    cand_age: torch.Tensor,
    cand_valid: torch.Tensor,
    port_busy: torch.Tensor,
    fresh_loc: torch.Tensor,
    parity_valid: torch.Tensor,
    region_slot: torch.Tensor,
    parked_count: torch.Tensor,
    rc_bank: torch.Tensor,
    rc_row: torch.Tensor,
    rc_valid: torch.Tensor,
    rs_active: Optional[int] = None,
    down=None,
) -> WritePlan:
    if down is not None:
        raise NotImplementedError("fault injection (down banks) is not "
                                  "ported yet")
    dev = cand_bank.device
    n = cand_bank.shape[0]
    K = MAX_OPTS
    P = p.n_ports
    R = p.n_rows
    rs = p.region_size
    rs_a = rs if rs_active is None else int(rs_active)
    order, n_trips = _walk_bounds(cand_age, cand_valid)
    # one host read per walk: the trip count and, in walk order, every
    # candidate's (bank, row), which address the walk's scalar state
    host = torch.cat([n_trips.long().view(1),
                      cand_bank[order].long().clamp(min=0),
                      cand_row[order].long().clamp(min=0)]).tolist()
    n_trips = host[0]

    served = torch.zeros((n,), dtype=torch.bool, device=dev)
    mode = torch.full((n,), WMODE_UNSERVED, dtype=torch.int32, device=dev)
    port_busy = port_busy.clone()
    fresh = fresh_loc.flatten().clone()
    n_pv_rows = parity_valid.shape[1]
    # parity validity and the recode ring with one trailing sink entry each
    # for masked writes
    pv = torch.cat([parity_valid.flatten(), parity_valid.new_zeros(1)])
    pv_sink = pv.shape[0] - 1
    cap = rc_valid.shape[0]
    ring_b = torch.cat([rc_bank, rc_bank.new_zeros(1)])
    ring_r = torch.cat([rc_row, rc_row.new_zeros(1)])
    ring_v = torch.cat([rc_valid, rc_valid.new_zeros(1)])
    parked_count = parked_count.clone()
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    if n_trips > 0:
        oc = order[:n_trips]
        hb = host[1:1 + n_trips]
        hi = host[1 + n:1 + n + n_trips]
        b = cand_bank[oc].long().clamp(min=0)
        i = cand_row[oc].long().clamp(min=0)
        valid = cand_valid[oc]
        slot = region_slot[i // rs_a].long()
        coded = slot >= 0
        pr = slot.clamp(min=0) * rs + i % rs_a
        optj = t.opt_parity[b]                                  # (T, K)
        optjj = optj.clamp(min=0)
        opt_pport = t.par_port[optjj]
        opt_pport = torch.where(opt_pport < 0, P, opt_pport)
        mem = t.par_members[optjj]                              # (T, K, 3)
        mem_other = (mem >= 0) & (mem != b[:, None, None])
        mem_fl = (mem.clamp(min=0) * R + i[:, None, None]).flatten(1)
        opt_code = (optj >= 0) & coded[:, None]
        pv_idx = optjj * n_pv_rows + pr[:, None]                # (T, K)
        parked_at = (optjj + 1).repeat_interleave(3, dim=1)     # (T, 3K)
        # per action a (0 = DIRECT, 1 + k = PARK(k)): its port, the fresh
        # location it leaves, whether it is a park, whether it requests a
        # recode, and which covering parities it invalidates
        ports = torch.cat([b[:, None], opt_pport], 1)           # (T, A)
        base = torch.cat([valid[:, None], valid[:, None] & opt_code], 1)
        is_park = torch.arange(K + 1, device=dev) > 0
        new_fl = torch.cat([torch.zeros_like(b)[:, None], optjj + 1], 1)
        need_rc = torch.cat([(coded & (t.opt_n[b] > 0))[:, None],
                             torch.ones_like(opt_code)], 1)
        inv = torch.cat([opt_code[:, None],
                         opt_code[:, None] & (optjj[:, :, None]
                                              == optjj[:, None, :])], 1)
        table = torch.cat([ports, new_fl, need_rc.long()], 1)   # (T, 3A)
        scores = torch.arange(1, K + 2, device=dev)             # 1, 2 + k
        no = torch.zeros((1,), dtype=torch.bool, device=dev)
        acts = []
        for k in range(n_trips):
            bc, ic = hb[k], hi[k]
            cell = bc * R + ic
            flc = fresh[cell]
            rc_full = ring_v[:cap].all()
            occ = (mem_other[k].flatten()
                   & (fresh[mem_fl[k]] == parked_at[k])).view(K, 3).any(1)
            blocked = torch.cat([no, occ | rc_full])
            feas = base[k] & ~(port_busy[ports[k]] | blocked)
            val, act = torch.where(feas, scores, INF_SCORE).min(0, True)
            found = val < INF_SCORE
            row = table[k].view(3, K + 1)[:, act].flatten()     # (3,)
            port_busy.index_fill_(0, torch.where(found, row[0], P), True)
            # --- freshness bookkeeping
            parked = is_park[act] & found
            was_parked = flc > 0
            fresh[cell] = torch.where(found, row[1].int(), flc)[0]
            parked_count[hi[k] // rs_a] += (
                (parked & ~was_parked).int()
                - ((found & ~parked) & was_parked).int())[0]
            pv.index_put_((torch.where(inv[k][act][0] & found, pv_idx[k],
                                       pv_sink),), no[0])
            # recode request so freshness is eventually restored
            want = found & (row[2] > 0)
            ok = _rc_push(ring_b, ring_r, ring_v, bc, ic, want)
            dropped += (want & ~ok).int()[0]
            acts.append(torch.where(found, act, WMODE_UNSERVED))
        act = torch.cat(acts)
        served.index_put_((oc,), act >= 0)
        mode.index_put_((oc,), act.int())
    port_busy[P] = True                        # deterministic sink
    n_served, n_parked = _plan_counts(served, mode >= WMODE_PARK0)
    return WritePlan(served, mode, port_busy, fresh.view_as(fresh_loc),
                     pv[:-1].view_as(parity_valid), parked_count,
                     ring_b[:-1].clone(), ring_r[:-1].clone(),
                     ring_v[:-1].clone(), n_served, n_parked, dropped)


def _rc_push(ring_b, ring_r, ring_v, b: int, i: int,
             do: torch.Tensor) -> torch.Tensor:
    """Push (b, i) into the recode ring unless present, in place. The ring
    buffers carry one trailing sink slot that takes the masked write.
    Returns the (1,) ok flag (present, or a free slot existed)."""
    cap = ring_v.shape[0] - 1
    valid = ring_v[:cap]
    dup = (valid & (ring_b[:cap] == b) & (ring_r[:cap] == i)).any()
    free = ~valid
    has_free = free.any()
    idx = free.int().argmax()                  # first free slot
    at = torch.where(do & ~dup & has_free, idx, cap).view(1)
    ring_b.index_fill_(0, at, b)
    ring_r.index_fill_(0, at, i)
    ring_v.index_fill_(0, at, True)
    return dup | has_free
