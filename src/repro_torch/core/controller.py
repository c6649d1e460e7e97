"""Read/write pattern builders (paper §IV-B, §IV-C), port of
``repro/core/controller.py``.

Both builders are greedy matchers: candidates are visited oldest first
(a stable age sort, invalid slots keyed to +inf) and each takes the
cheapest feasible serving action this cycle. The semantics, scores and
tie-breaks are the JAX builders' line for line; plans are bit-identical.

Read actions (score): FROM_SYM (0), DIRECT (3), OPT(k) (2 · banks used),
REDIRECT (2). Write actions: DIRECT (1), PARK(k) (2 + k).

The point axis. ``build_read_patterns`` / ``build_write_patterns`` walk B
points lock-step: every input has a leading (B,) axis and ``rs_active`` is
an int (one geometry) or a (B,) tensor (each point's own region size in a
padded allocation). JAX ``vmap``s a ``lax.while_loop`` of ``n_trips = last
valid position + 1`` trips, so under its batch the loop runs the largest
point's trips with the finished points masked. Here the trip count over
the whole batch is read to the host once per walk (one sync), and the
loop runs that many trips; a point's candidates past its own last valid
one are invalid, and an invalid candidate is a no-op. Everything
loop-invariant is gathered once, in walk order, so trip ``k`` reads column
``k`` of each table, and each action's effects (ports, symbols, freshness,
recode request, invalidations) sit in per-candidate tables picked by the
chosen action. State the walk addresses per point (port claims, symbols,
freshness, parity validity, parked counts) lives in flat buffers with
each point's offset baked into the indices, so one gather or scatter
serves the batch; masked writes land on sink entries. Nothing is indexed
with a 0-d tensor (that would call ``.item()`` and sync the card). The
read walk keeps each point's port claims and chained-decode symbol
bit-matrix in one flat bool row (ports, the sink slot ``n_ports``, then
symbols), so a trip reads with one gather and claims with one scatter;
JAX marks the sink busy after every walk anyway.

``build_read_pattern`` / ``build_write_pattern`` are one point's walk: the
batched walk on a batch of one.

Index tables are int64 here (torch indexes with int64); plan outputs keep
the JAX dtypes (int32 modes, bool masks).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.codes import MAX_OPTS, CodeTables
from repro_torch.core.state import (INT32_MAX, MemParams, batch_of_one,
                                    point_of)

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
    """One point's shapes; a batched plan has a leading (B,) axis."""

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


def col(x):
    """A per-point geometry value shaped to broadcast over (B, N) tables:
    an int stays an int, a (B,) tensor becomes (B, 1)."""
    return x.view(-1, 1) if isinstance(x, torch.Tensor) else x


def point_offsets(B: int, stride: int, device):
    """(B, 1) int64 offsets ``b * stride`` of each point's slice of a flat
    batched buffer, or None for B = 1 (nothing to add)."""
    if B == 1:
        return None
    return torch.arange(B, device=device)[:, None] * stride


def add_offset(x: torch.Tensor, off):
    """``x + off``, or ``x`` itself when ``off`` is None."""
    return x if off is None else x + off


def _trip_major(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) → (T, B, ...) contiguous, so trip ``k`` is a contiguous
    row (free at B = 1)."""
    return x.transpose(0, 1).contiguous()


def _walk_bounds(cand_age: torch.Tensor, cand_valid: torch.Tensor):
    """Each point's stable age order (invalid slots last) and the trip
    bound covering every valid candidate of the batch, as a 0-d tensor."""
    n = cand_age.shape[1]
    order = torch.argsort(torch.where(cand_valid, cand_age, INT32_MAX),
                          dim=1, stable=True)
    pos = torch.arange(n, dtype=torch.int32, device=cand_age.device)
    last = torch.where(cand_valid.gather(1, order), pos, -1).max()
    return order, last + 1


def _plan_counts(served: torch.Tensor, sel: torch.Tensor):
    return (served.sum(1, dtype=torch.int32),
            (served & sel).sum(1, dtype=torch.int32))


def build_read_pattern(p: MemParams, t: JTables, *args,
                       rs_active: Optional[int] = None) -> ReadPlan:
    """One point's read plan (``build_read_patterns`` on a batch of one;
    the arguments are its, unbatched)."""
    return point_of(build_read_patterns(p, t, *batch_of_one(args),
                                        rs_active=rs_active), 0)


def build_write_pattern(p: MemParams, t: JTables, *args,
                        rs_active: Optional[int] = None,
                        down=None) -> WritePlan:
    """One point's write plan (``build_write_patterns`` on a batch of
    one)."""
    return point_of(build_write_patterns(p, t, *batch_of_one(args),
                                         rs_active=rs_active, down=down), 0)


def build_read_patterns(
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
    rs_active=None,
) -> ReadPlan:
    """B points' read plans: candidates (B, N), ``port_busy`` (B, P + 1),
    ``fresh_loc`` (B, n_data, L), ``parity_valid`` (B, n_par, Lp),
    ``region_slot`` (B, n_regions)."""
    dev = cand_bank.device
    B, n = cand_bank.shape
    K = MAX_OPTS
    P = p.n_ports
    R = p.n_rows
    rs = p.region_size
    rs_a = col(rs if rs_active is None else rs_active)
    order, n_trips = _walk_bounds(cand_age, cand_valid)
    # analysis: host-sync one read a walk: its trip count bounds the loop
    n_trips = int(n_trips)

    served = torch.zeros((B, n), dtype=torch.bool, device=dev)
    mode = torch.full((B, n), MODE_UNSERVED, dtype=torch.int32, device=dev)
    so = P + 1                                 # symbols follow the ports
    S = so + p.n_data * R                      # one point's busy row
    busy = torch.cat([port_busy, torch.zeros((B, p.n_data * R),
                                             dtype=torch.bool, device=dev)],
                     1).flatten()
    if n_trips > 0:
        # ---- per-candidate tables in walk order, gathered once
        oc = order[:, :n_trips]
        b = cand_bank.gather(1, oc).long().clamp(min=0)
        i = cand_row.gather(1, oc).long().clamp(min=0)
        valid = cand_valid.gather(1, oc)
        fl = fresh_loc.flatten(1).gather(1, b * R + i).long()
        slot = region_slot.gather(1, i // rs_a).long()
        coded = slot >= 0
        pr = slot.clamp(min=0) * rs + i % rs_a
        hold_port = t.par_port[(fl - 1).clamp(min=0)]
        # a scheme with no parities points the REDIRECT claim at the sink
        hold_idx = torch.where(hold_port < 0, P, hold_port)
        optj = t.opt_parity[b]                                  # (B, T, K)
        optjj = optj.clamp(min=0)
        n_pr = parity_valid.shape[2]
        opt_pv = (optj >= 0) & coded[..., None] & parity_valid.flatten(
            1).gather(1, (optjj * n_pr + pr[..., None]).flatten(1)).view(
                optj.shape)
        opt_pport = t.par_port[optjj]
        opt_pport = torch.where(opt_pport < 0, P, opt_pport)
        sibs = t.opt_sibs[b].transpose(-1, -2)                  # (B, T, 2, K)
        has = sibs >= 0
        sib = sibs.clamp(min=0)
        may_serve = valid & (fl == 0)
        can_rd = valid & (fl > 0)
        opt_may = may_serve[..., None] & opt_pv
        sym_b = so + b * R + i
        sym_s = so + sib * R + i[..., None, None]               # (B, T, 2, K)
        off = point_offsets(B, S, dev)
        off3 = None if off is None else off[..., None]
        # gather row: [sym b, port b, port hold, K parity ports,
        #              2K sibling ports, 2K sibling symbols]
        gidx = add_offset(torch.cat([sym_b[..., None], b[..., None],
                               hold_idx[..., None], opt_pport,
                               sib.flatten(2), sym_s.flatten(2)], 2), off3)
        # the three scalar actions (FROM_SYM, DIRECT, REDIRECT) are feasible
        # where the gathered bit differs from ``inv3``
        base3 = torch.stack([may_serve & bool(p.coalesce), may_serve,
                             can_rd], 2)
        inv3 = torch.tensor([False, True, True], device=dev)
        score3 = torch.tensor([0, 3, 2], device=dev)
        # claims of each action a: [port, sym b, sym sib0, sym sib1];
        # sibling ports are claimed only where the symbol is not yet held
        sink = torch.full_like(b, P)
        sym_sib = torch.where(has, sym_s, P)                    # (B, T, 2, K)
        claims = add_offset(torch.cat([
            torch.stack([sink, sink, sink, sink], 2)[:, :, None],         # sym
            torch.stack([b, sym_b, sink, sink], 2)[:, :, None],           # dir
            torch.stack([opt_pport, sym_b[..., None].expand(-1, -1, K),
                         sym_sib[:, :, 0], sym_sib[:, :, 1]], 3),         # opt
            torch.stack([hold_idx, sink, sink, sink], 2)[:, :, None],     # rd
        ], 2), None if off is None else off[..., None, None])  # (B, T, A, 4)
        sinkp = torch.full((B, 1, 1), P, dtype=torch.int64, device=dev)
        sib = add_offset(sib, None if off is None else off[..., None, None])
        if off is not None:
            sinkp += off[..., None]
        pad2 = sinkp.expand(B, 2, 2)
        pad1 = sinkp.expand(B, 2, 1)
        gidx, claims, sib, has, opt_may, base3 = map(
            _trip_major, (gidx, claims, sib, has, opt_may, base3))
        vals, acts = [], []
        for k in range(n_trips):
            g = busy[gidx[k]]                                   # (B, G)
            pb_s = g[:, 3 + K:3 + 3 * K].view(B, 2, K)
            sy_s = g[:, 3 + 3 * K:].view(B, 2, K)
            need = has[k] & ~sy_s                               # (B, 2, K)
            blocked = (need & pb_s).any(1)
            feas = opt_may[k] & ~(g[:, 3:3 + K] | blocked)
            opt_sc = torch.where(feas, need.sum(1) * 2 + 2, INF_SCORE)
            sc3 = torch.where(base3[k] & (g[:, 0:3] != inv3), score3,
                              INF_SCORE)
            val, act = torch.cat([sc3[:, :2], opt_sc, sc3[:, 2:]],
                                 1).min(1, True)
            sports = torch.cat([pad2, torch.where(need, sib[k], sinkp), pad1],
                               2)
            upd = torch.cat([claims[k], sports.transpose(1, 2)], 2)
            busy.index_fill_(0, upd.gather(1, act[..., None].expand(
                B, 1, 6)).flatten(), True)
            vals.append(val)
            acts.append(act)
        found = torch.cat(vals, 1) < INF_SCORE
        served.scatter_(1, oc, found)
        mode.scatter_(1, oc, torch.where(found, torch.cat(acts, 1),
                                         MODE_UNSERVED).int())
    port_busy = busy.view(B, S)[:, :P + 1].clone()
    # the masked no-op claims land on the sink slot; mark it busy even when
    # the walk reaches no valid candidate, as JAX does
    port_busy[:, P] = True
    n_served, n_degraded = _plan_counts(
        served, (mode == MODE_FROM_SYM)
        | ((mode >= MODE_OPT0) & (mode < MODE_REDIRECT)))
    return ReadPlan(served, mode, port_busy, n_served, n_degraded)


def build_write_patterns(
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
    rs_active=None,
    down=None,
) -> WritePlan:
    """B points' write plans; shapes as in ``build_read_patterns``, plus
    ``parked_count`` (B, n_regions) and the recode ring (B, RC).

    ``down`` (B, n_data), fault injection: each point's down data banks
    (degraded-write mode, as JAX's builder). A candidate is *sticky* when
    its own bank is down or a parity option covering it has a down
    member: its park stays parked (no recode request) until the rebuild
    sweep drains it, and it waives the recode-space requirement. Scores
    prefer (a) normal parks, (b) parks into parities whose members are all
    alive, (c) parks into down-covering parities, (d) a direct write,
    strictly last for a sticky candidate."""
    dev = cand_bank.device
    B, n = cand_bank.shape
    K = MAX_OPTS
    P = p.n_ports
    R = p.n_rows
    nd = p.n_data
    rs = p.region_size
    rs_a = col(rs if rs_active is None else rs_active)
    order, n_trips = _walk_bounds(cand_age, cand_valid)
    # analysis: host-sync one read a walk: its trip count bounds the loop
    n_trips = int(n_trips)

    served = torch.zeros((B, n), dtype=torch.bool, device=dev)
    mode = torch.full((B, n), WMODE_UNSERVED, dtype=torch.int32, device=dev)
    port_busy = port_busy.flatten().clone()
    fresh = fresh_loc.flatten().clone()
    n_pv = parity_valid[0].numel()
    n_pv_rows = parity_valid.shape[2]
    # parity validity and each point's recode ring with one trailing sink
    # entry for masked writes
    pv = torch.cat([parity_valid.flatten(), parity_valid.new_zeros(1)])
    pv_sink = pv.shape[0] - 1
    cap = rc_valid.shape[1]
    ring_b = torch.cat([rc_bank, rc_bank.new_zeros(B, 1)], 1)
    ring_r = torch.cat([rc_row, rc_row.new_zeros(B, 1)], 1)
    ring_v = torch.cat([rc_valid, rc_valid.new_zeros(B, 1)], 1)
    n_regions = parked_count.shape[1]
    parked_count = parked_count.flatten().clone()
    dropped = torch.zeros((B,), dtype=torch.int32, device=dev)
    if n_trips > 0:
        oc = order[:, :n_trips]
        b = cand_bank.gather(1, oc).long().clamp(min=0)
        i = cand_row.gather(1, oc).long().clamp(min=0)
        valid = cand_valid.gather(1, oc)
        region = i // rs_a
        slot = region_slot.gather(1, region).long()
        coded = slot >= 0
        pr = slot.clamp(min=0) * rs + i % rs_a
        cell = add_offset(b * R + i, point_offsets(B, nd * R, dev))
        reg = add_offset(region, point_offsets(B, n_regions, dev))
        optj = t.opt_parity[b]                                  # (B, T, K)
        optjj = optj.clamp(min=0)
        opt_pport = t.par_port[optjj]
        opt_pport = torch.where(opt_pport < 0, P, opt_pport)
        mem = t.par_members[optjj]                              # (B, T, K, 3)
        mem_other = (mem >= 0) & (mem != b[..., None, None])
        poff = point_offsets(B, nd * R, dev)
        mem_fl = add_offset(mem.clamp(min=0) * R + i[..., None, None],
                      None if poff is None else poff[..., None, None]
                      ).flatten(2)                              # (B, T, 3K)
        opt_code = (optj >= 0) & coded[..., None]
        pv_idx = add_offset(optjj * n_pv_rows + pr[..., None],
                      None if poff is None else
                      point_offsets(B, n_pv, dev)[..., None])
        parked_at = (optjj + 1).repeat_interleave(3, dim=2)     # (B, T, 3K)
        # per action a (0 = DIRECT, 1 + k = PARK(k)): its port, the fresh
        # location it leaves, whether it is a park, whether it requests a
        # recode, and which covering parities it invalidates
        ports = torch.cat([b[..., None], opt_pport], 2)         # (B, T, A)
        pb_off = point_offsets(B, P + 1, dev)
        ports_g = add_offset(ports, None if pb_off is None
                             else pb_off[..., None])
        base = torch.cat([valid[..., None], valid[..., None] & opt_code], 2)
        is_park = torch.arange(K + 1, device=dev) > 0
        new_fl = torch.cat([torch.zeros_like(b)[..., None], optjj + 1], 2)
        need_rc = torch.cat([(coded & (t.opt_n[b] > 0))[..., None],
                             torch.ones_like(opt_code)], 2)
        inv = torch.cat([opt_code[:, :, None],
                         opt_code[:, :, None] & (optjj[..., :, None]
                                                 == optjj[..., None, :])], 2)
        scores = torch.arange(1, K + 2, device=dev)             # 1, 2 + k
        if down is not None:
            # degraded-write mode: per-candidate scores and recode requests
            opt_down = (mem_other & down.gather(1, mem.clamp(min=0).flatten(
                1)).view(mem.shape)).any(3)                     # (B, T, K)
            sticky = down.gather(1, b) | (opt_code & opt_down).any(2)
            scores = torch.cat([
                torch.where(sticky, 2 + 2 * K + 2, 1)[..., None],
                scores[1:] + torch.where(opt_down, K + 2, 0)], 2)
            need_rc[..., 1:] &= ~sticky[..., None]
        table = torch.cat([ports_g, new_fl, need_rc.long()],
                          2).view(B, n_trips, 3, K + 1)
        no = torch.zeros((B, 1), dtype=torch.bool, device=dev)
        sinkp = torch.full((B,), P, dtype=torch.int64, device=dev)
        if pb_off is not None:
            sinkp += pb_off[:, 0]
        b32, i32 = b.int(), i.int()
        (cell, reg, mem_other, mem_fl, parked_at, ports_g, base, table, inv,
         pv_idx, b32, i32) = map(_trip_major, (
             cell, reg, mem_other, mem_fl, parked_at, ports_g, base, table,
             inv, pv_idx, b32, i32))
        if down is not None:
            scores, sticky = _trip_major(scores), _trip_major(sticky)
        acts = []
        for k in range(n_trips):
            ck = cell[k]                                        # (B,)
            flc = fresh[ck]
            rc_full = ring_v[:, :cap].all(1, True)
            if down is not None:         # a sticky park needs no ring space
                rc_full = rc_full & ~sticky[k][:, None]
            occ = (mem_other[k].flatten(1)
                   & (fresh[mem_fl[k]] == parked_at[k])).view(B, K, 3).any(2)
            blocked = torch.cat([no, occ | rc_full], 1)
            feas = base[k] & ~(port_busy[ports_g[k]] | blocked)
            val, act = torch.where(feas, scores if down is None
                                   else scores[k], INF_SCORE).min(1, True)
            found = val < INF_SCORE                             # (B, 1)
            row = table[k].gather(2, act[:, None].expand(B, 3, 1))[..., 0]
            port_busy.index_fill_(0, torch.where(found[:, 0], row[:, 0],
                                                 sinkp), True)
            # --- freshness bookkeeping
            parked = is_park[act] & found
            was_parked = (flc > 0)[:, None]
            fresh.index_put_((ck,), torch.where(found[:, 0], row[:, 1].int(),
                                                flc))
            parked_count.index_add_(0, reg[k], (
                (parked & ~was_parked).int()
                - ((found & ~parked) & was_parked).int())[:, 0])
            inv_k = inv[k].gather(1, act[..., None].expand(B, 1, K))[:, 0]
            pv.index_put_((torch.where(inv_k & found, pv_idx[k], pv_sink),),
                          no[0, 0])
            # recode request so freshness is eventually restored
            want = found & (row[:, 2:] > 0)
            ok = _rc_push(ring_b, ring_r, ring_v, b32[k][:, None],
                          i32[k][:, None], want)
            dropped += (want & ~ok).int()[:, 0]
            acts.append(torch.where(found, act, WMODE_UNSERVED))
        act = torch.cat(acts, 1)
        served.scatter_(1, oc, act >= 0)
        mode.scatter_(1, oc, act.int())
    port_busy = port_busy.view(B, P + 1)
    port_busy[:, P] = True                     # deterministic sink
    n_served, n_parked = _plan_counts(served, mode >= WMODE_PARK0)
    return WritePlan(served, mode, port_busy, fresh.view_as(fresh_loc),
                     pv[:-1].view_as(parity_valid),
                     parked_count.view(B, n_regions),
                     ring_b[:, :-1].clone(), ring_r[:, :-1].clone(),
                     ring_v[:, :-1].clone(), n_served, n_parked, dropped)


def _rc_push(ring_b, ring_r, ring_v, b: torch.Tensor, i: torch.Tensor,
             do: torch.Tensor) -> torch.Tensor:
    """Push each point's (b, i) into its recode ring unless present, in
    place. The (B, RC + 1) ring buffers carry one trailing sink column that
    takes the masked write; ``b``, ``i`` (B, 1) int32, ``do`` (B, 1).
    Returns the (B, 1) ok flag (present, or a free slot existed)."""
    cap = ring_v.shape[1] - 1
    valid = ring_v[:, :cap]
    dup = (valid & (ring_b[:, :cap] == b) & (ring_r[:, :cap] == i)).any(
        1, True)
    free = ~valid
    has_free = free.any(1, True)
    idx = free.int().argmax(1, True)           # first free slot
    at = torch.where(do & ~dup & has_free, idx, cap)
    ring_b.scatter_(1, at, b)
    ring_r.scatter_(1, at, i)
    ring_v.scatter_(1, at, True)
    return dup | has_free
