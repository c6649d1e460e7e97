"""Paged, banked + coded KV page pool of the serving path
(``repro.runtime.kvbank`` counterpart): the layered pool ops of the
serving step and the per-sequence ``BankedKVState`` API (``init_state``,
``append_token``, ``recode``, ``plan_reads``, ``gather_kv``).

Physical page ``p`` lives in bank ``p % NB``, slot ``p // NB``; parity group
``g`` holds ``bank[2g] ^ bank[2g+1]``. Every sequence owns a page-table row
assigned on the host. Appends mark the touched parity rows stale in the
code-status table; the read planner serves every second read of a bank
hotter than its pair sibling from (sibling ^ parity) when that row's
parity is fresh; the ReCoding unit refreshes stale rows, either fused into
the write (``par' = par ^ old ^ new``) or in a budgeted pass.

Unlike the JAX package, which returns new arrays, the ops here UPDATE the
pool's tensors IN PLACE (the pool-level ops also return the pool): copying
a full-width pool every step would double its memory. ``pool_permute``, a
defrag off the step path, stages one permuted copy of a bank array at a
time before writing it back, so it too keeps the tensors. Lanes are signed
integer views (see ``kernels/common.py``). The JAX ops send dead lanes to an out-of-range sink
with ``mode="drop"``; here dead lanes are filtered out (payload writes) or
sent to one extra sink row that is sliced off (counts and status bits).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.coded_kv_decode.ops import gather_pool_layer
from repro_torch.kernels.common import lane_dtype

Lanes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class KVBankConfig:
    n_banks: int = 8            # data banks (parity pairs: 2g, 2g+1)
    page: int = 16              # tokens per page
    pool_pages: int = 1024      # physical pages in the pool
    max_pages: int = 256        # logical pages per sequence (table width)


class ReadPlan(NamedTuple):
    use_parity: torch.Tensor      # (B, max_pages) bool
    uncoded_cycles: torch.Tensor  # () max bank load, whole step
    coded_cycles: torch.Tensor    # () port cycles with parity serving
    load: torch.Tensor            # (n_banks,) needed pages per bank


@dataclasses.dataclass
class PooledKV:
    """Layered serving pool: one shared page table over per-layer banks.
    ``k_par.shape[1] == 0`` is the uncoded pool (no parity, no status)."""
    k_banks: torch.Tensor       # (L, NB, slots, page, Hkv, D) lanes
    v_banks: torch.Tensor
    k_par: torch.Tensor         # (L, NB/2 or 0, slots, page, Hkv, D)
    v_par: torch.Tensor
    parity_fresh: torch.Tensor  # (NB/2 or 0, slots) bool code-status table
    page_table: torch.Tensor    # (B, max_pages) int32 physical id, -1 free
    length: torch.Tensor        # (B,) int32 tokens present (= decode pos)


@dataclasses.dataclass
class BankedKVState:
    """One layer's banked + coded KV over a pool whose pages are allocated
    in arrival order (``repro`` kvbank.py:47)."""
    k_banks: torch.Tensor       # (NB, slots, page, Hkv, D) lanes
    v_banks: torch.Tensor
    k_par: torch.Tensor         # (NB/2, slots, page, Hkv, D)
    v_par: torch.Tensor
    parity_fresh: torch.Tensor  # (NB/2, slots) bool code-status table
    page_table: torch.Tensor    # (B, max_pages) int32 physical id, -1 free
    length: torch.Tensor        # (B,) int32 tokens present
    next_page: torch.Tensor     # () int32 pool allocation cursor


class WriteLanes(NamedTuple):
    """A step's live write lanes, split by bank parity (phase 0: even
    banks, phase 1: odd banks). Each phase is ``(rows, bank, slot,
    in_page)`` index tensors; computed once per step so the per-layer
    scatters need no host sync."""
    phases: Tuple[Lanes, Lanes]


def parity_members(n_banks: int):
    """The pool's parity layout as explicit (members, phys) tables
    (``repro`` kvbank.py:319): group ``g`` protects data banks (2g, 2g+1)
    behind its own physical parity port. ``pool_init`` sizes the parity
    groups from it and ``repro_torch.analysis.schemes`` certifies it."""
    members = [[2 * g, 2 * g + 1] for g in range(n_banks // 2)]
    return members, list(range(n_banks // 2))


def pool_init(cfg: KVBankConfig, n_layers: int, batch: int, n_kv: int,
              head_dim: int, dtype: torch.dtype, *, device,
              coded: bool = True) -> PooledKV:
    u = lane_dtype(dtype)
    nb, pg = cfg.n_banks, cfg.page
    slots = cfg.pool_pages // nb
    ng = len(parity_members(nb)[0]) if coded else 0
    shape = (n_layers, nb, slots, pg, n_kv, head_dim)
    pshape = (n_layers, ng, slots, pg, n_kv, head_dim)
    return PooledKV(
        k_banks=torch.zeros(shape, dtype=u, device=device),
        v_banks=torch.zeros(shape, dtype=u, device=device),
        k_par=torch.zeros(pshape, dtype=u, device=device),
        v_par=torch.zeros(pshape, dtype=u, device=device),
        parity_fresh=torch.ones((ng, slots), dtype=torch.bool, device=device),
        page_table=torch.full((batch, cfg.max_pages), -1, dtype=torch.int32,
                              device=device),
        length=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def init_state(cfg: KVBankConfig, batch: int, n_kv: int, head_dim: int,
               dtype: torch.dtype, *, device) -> BankedKVState:
    """An empty state (``repro`` kvbank.py:69): zero banks, fresh parity,
    no page assigned, allocation cursor 0."""
    pool = pool_init(cfg, 1, batch, n_kv, head_dim, dtype, device=device)
    return BankedKVState(
        k_banks=pool.k_banks[0], v_banks=pool.v_banks[0],
        k_par=pool.k_par[0], v_par=pool.v_par[0],
        parity_fresh=pool.parity_fresh, page_table=pool.page_table,
        length=pool.length,
        next_page=torch.zeros((), dtype=torch.int32, device=device))


def _as_pool(st: BankedKVState) -> PooledKV:
    """The state as a one-layer pool of views: the pool ops write through
    to the state's tensors."""
    return PooledKV(k_banks=st.k_banks[None], v_banks=st.v_banks[None],
                    k_par=st.k_par[None], v_par=st.v_par[None],
                    parity_fresh=st.parity_fresh, page_table=st.page_table,
                    length=st.length)


def append_token(cfg: KVBankConfig, st: BankedKVState, k_new: torch.Tensor,
                 v_new: torch.Tensor,
                 active: Optional[torch.Tensor] = None) -> BankedKVState:
    """Append one token's (B, Hkv, D) K/V for every ``active`` sequence, in
    place (``repro`` kvbank.py:86). A sequence at a page boundary takes the
    next pool page (arrival-order allocation); the touched parity rows go
    stale. As in JAX, a table write past ``max_pages`` is dropped and the
    table read there clamps, and a token on a page past the pool is
    dropped."""
    b = st.length.shape[0]
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=st.length.device)
    ku, vu = _as(k_new, st.k_banks.dtype), _as(v_new, st.v_banks.dtype)
    nb = cfg.n_banks
    pos = st.length.long()
    lpage, in_page = pos // cfg.page, pos % cfg.page
    lp = lpage.clamp(max=cfg.max_pages - 1)
    rows = torch.arange(b, device=pos.device)
    need = active & (in_page == 0)
    n_need = need.to(torch.int32)
    new_phys = st.next_page + torch.cumsum(n_need, 0, dtype=torch.int32) \
        - n_need
    fill = torch.where(need, new_phys, st.page_table[rows, lp])
    # analysis: host-sync an append's in-range pages (one sequence's step)
    inb = torch.nonzero(lpage < cfg.max_pages).squeeze(1)
    st.page_table[inb, lpage[inb]] = fill[inb]
    st.next_page += n_need.sum(dtype=torch.int32)
    phys = st.page_table[rows, lp].long()
    bank, slot = phys % nb, (phys // nb).clamp(min=0)
    # analysis: host-sync an append's live lanes (one sequence's step)
    live = torch.nonzero(active & (slot < st.k_banks.shape[1])).squeeze(1)
    bank, slot, ip = bank[live], slot[live], in_page[live]
    st.k_banks[bank, slot, ip] = ku[live]
    st.v_banks[bank, slot, ip] = vu[live]
    st.parity_fresh[bank // 2, slot] = False
    st.length += active.to(st.length.dtype)
    return st


def recode(cfg: KVBankConfig, st: BankedKVState,
           budget: Optional[int] = None) -> BankedKVState:
    """The ReCoding unit over the state, in place (``repro``
    kvbank.py:155): every stale row when ``budget`` is None, else the
    first ``budget`` stale rows in raster order (``pool_recode``)."""
    pool_recode(cfg, _as_pool(st), budget=budget)
    return st


def _clamped_table(cfg: KVBankConfig, st: BankedKVState) -> torch.Tensor:
    """The page table with every page past the pool moved to its bank's
    last slot: JAX's gathers clamp such a slot, so its plan and reads see
    that page."""
    nb, slots = cfg.n_banks, st.k_banks.shape[1]
    pt = st.page_table
    return torch.where(pt >= nb * slots, pt % nb + nb * (slots - 1), pt)


def plan_reads(cfg: KVBankConfig, st: BankedKVState) -> ReadPlan:
    """This step's page-read plan (``repro`` kvbank.py:192)."""
    return _plan_from_tables(cfg, _clamped_table(cfg, st), st.length,
                             st.parity_fresh)


def gather_kv(cfg: KVBankConfig, st: BankedKVState, plan: ReadPlan,
              dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The logical (B, max_pages * page, Hkv, D) K/V in ``dtype`` through
    the planned mix of direct and degraded reads (``repro``
    kvbank.py:253); unallocated pages read zero. The same function as the
    serving pool's gather, so on the card it is ``gather_pool_cuda``."""
    return gather_pool_layer(st.k_banks, st.v_banks, st.k_par, st.v_par,
                             _clamped_table(cfg, st), plan.use_parity, dtype)


def pool_coded(pool: PooledKV) -> bool:
    return pool.k_par.shape[1] > 0


def _as(x: torch.Tensor, lanes: torch.dtype) -> torch.Tensor:
    return x if x.dtype == lanes else x.view(lanes)


def _count(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Histogram of ``idx`` over ``[0, n)``; ``idx == n`` is dropped."""
    out = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
    out.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
    return out[:n]


def pool_write_index(cfg: KVBankConfig, pool: PooledKV, active: torch.Tensor):
    """(bank, slot, in_page) targets of this step's one-token write per
    sequence; dead (inactive or table-exhausted) lanes get bank ``NB``."""
    b = pool.length.shape[0]
    pos = pool.length.long()
    lpage = pos // cfg.page
    in_page = pos % cfg.page
    rows = torch.arange(b, device=pos.device)
    phys = pool.page_table[rows, lpage.clamp(max=cfg.max_pages - 1)].long()
    ok = active & (lpage < cfg.max_pages) & (phys >= 0)
    bank = torch.where(ok, phys % cfg.n_banks, cfg.n_banks)
    slot = (phys // cfg.n_banks).clamp(min=0)
    return bank, slot, in_page


def write_lanes(cfg: KVBankConfig, widx) -> WriteLanes:
    bank, slot, in_page = widx
    live = bank < cfg.n_banks
    phases = []
    for phase in (0, 1):
        # analysis: host-sync once a step, so the layers' scatters need none
        rows = torch.nonzero(live & (bank % 2 == phase)).squeeze(1)
        phases.append((rows, bank[rows], slot[rows], in_page[rows]))
    return WriteLanes(tuple(phases))


def pool_mark_stale(cfg: KVBankConfig, pool: PooledKV, widx) -> PooledKV:
    """Code-status update for this step's writes (paper §IV-A status 01)."""
    ng, slots = pool.parity_fresh.shape
    if ng == 0:
        return pool
    bank, slot, _ = widx
    grp = torch.where(bank < cfg.n_banks, bank // 2, ng)
    padded = torch.cat([pool.parity_fresh,
                        pool.parity_fresh.new_ones((1, slots))])
    padded[grp, slot] = False
    pool.parity_fresh.copy_(padded[:ng])
    return pool


def pool_write_layer(cfg: KVBankConfig, k_bank: torch.Tensor,
                     v_bank: torch.Tensor, lanes: WriteLanes,
                     k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """Write one token's (B, Hkv, D) K/V into ONE layer's banks, in place."""
    ku, vu = _as(k_new, k_bank.dtype), _as(v_new, v_bank.dtype)
    for rows, bank, slot, in_page in lanes.phases:
        k_bank[bank, slot, in_page] = ku[rows]
        v_bank[bank, slot, in_page] = vu[rows]


def pool_write_layer_fused(cfg: KVBankConfig, k_bank: torch.Tensor,
                           v_bank: torch.Tensor, k_par: torch.Tensor,
                           v_par: torch.Tensor, lanes: WriteLanes,
                           k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """Encode-on-write, in place: write one token's K/V into one layer's
    banks and delta-maintain the pair parity (``par' = par ^ old ^ new``).

    The deltas are read before the bank write. Parity is updated in two
    passes, even banks then odd banks: within a pass two lanes on one
    parity element would be one physical page element, which distinct
    sequences never share, so the scatter cannot collide; the second pass
    reads what the first wrote."""
    ku, vu = _as(k_new, k_bank.dtype), _as(v_new, v_bank.dtype)
    deltas = [(k_bank[bank, slot, ip] ^ ku[rows],
               v_bank[bank, slot, ip] ^ vu[rows])
              for rows, bank, slot, ip in lanes.phases]
    pool_write_layer(cfg, k_bank, v_bank, lanes, k_new, v_new)
    for (rows, bank, slot, ip), (dk, dv) in zip(lanes.phases, deltas):
        grp = bank // 2
        k_par[grp, slot, ip] = k_par[grp, slot, ip] ^ dk
        v_par[grp, slot, ip] = v_par[grp, slot, ip] ^ dv


def pool_read_sets(cfg: KVBankConfig, page_table: torch.Tensor,
                   length: torch.Tensor):
    """(needed, bank) tables for a step's page reads."""
    mp = page_table.shape[1]
    n_pages = (length.long() + cfg.page - 1) // cfg.page
    needed = (torch.arange(mp, device=page_table.device)[None, :]
              < n_pages[:, None]) & (page_table >= 0)
    bank = page_table.long().clamp(min=0) % cfg.n_banks
    return needed, bank


def _plan_from_tables(cfg: KVBankConfig, page_table: torch.Tensor,
                      length: torch.Tensor,
                      parity_fresh: Optional[torch.Tensor]) -> ReadPlan:
    """The step's read plan over bare tables (``repro`` kvbank.py:211).
    For every bank hotter than its pair sibling, up to
    ``(load - sib) // 2`` of its fresh-parity reads go degraded (odd ranks,
    batch-major order). ``parity_fresh=None`` plans an uncoded pool."""
    b, mp = page_table.shape
    nb = cfg.n_banks
    needed, bank = pool_read_sets(cfg, page_table, length)
    slot = page_table.long().clamp(min=0) // nb
    if parity_fresh is None:
        fresh = torch.zeros_like(needed)
    else:
        fresh = parity_fresh[bank // 2, slot]
    load = _count(torch.where(needed, bank, nb), nb)
    sib_load = load[torch.arange(nb, device=load.device) ^ 1]
    k_bank = (load - sib_load).clamp(min=0) // 2

    oh = (needed & fresh)[..., None] * F.one_hot(bank, nb)
    flat = oh.reshape(b * mp, nb)
    rank = (torch.cumsum(flat, 0) - flat).reshape(b, mp, nb)
    my_rank = torch.gather(rank, -1, bank[..., None])[..., 0]
    use_parity = (needed & fresh & (my_rank % 2 == 1)
                  & (my_rank < 2 * k_bank[bank]))

    direct = needed & ~use_parity
    d_bank = _count(torch.where(direct, bank, nb), nb)
    s_bank = _count(torch.where(use_parity, bank ^ 1, nb), nb)
    p_bank = _count(torch.where(use_parity, bank // 2, nb // 2), nb // 2)
    coded = torch.maximum((d_bank + s_bank).max(), p_bank.max())
    return ReadPlan(use_parity=use_parity, uncoded_cycles=load.max(),
                    coded_cycles=coded, load=load)


def read_latencies(cfg: KVBankConfig, page_table: torch.Tensor,
                   length: torch.Tensor,
                   use_parity: torch.Tensor) -> torch.Tensor:
    """Per-page critical-word latency (port cycles) under the planned
    serving order, (B, max_pages) int32, 0 for pages not read this step
    (``repro`` kvbank.py:282). Each bank port serves its direct reads
    first in request (batch-major) order, then lends cycles to its pair
    sibling's degraded reads; each parity port serves its group's degraded
    reads in request order; a degraded read completes when both its words
    have arrived. The maximum over the step equals the plan's
    ``coded_cycles`` (``uncoded_cycles`` when nothing is degraded)."""
    b, mp = page_table.shape
    nb = cfg.n_banks
    needed, bank = pool_read_sets(cfg, page_table, length)
    use_parity = use_parity.bool()
    direct = needed & ~use_parity
    deg = needed & use_parity

    def rank_of(mask, idx, n):
        oh = mask[..., None] * F.one_hot(idx, n)
        flat = oh.reshape(b * mp, n)
        r = (torch.cumsum(flat, 0) - flat).reshape(b, mp, n)
        return torch.gather(r, -1, idx[..., None])[..., 0]

    d_rank = rank_of(direct, bank, nb)
    s_rank = rank_of(deg, bank, nb)          # degraded share a sibling port
    p_rank = rank_of(deg, bank // 2, nb // 2)
    d_bank = _count(torch.where(direct, bank, nb), nb)
    lat_deg = 1 + torch.maximum(d_bank[bank ^ 1] + s_rank, p_rank)
    lat = torch.where(deg, lat_deg, torch.where(direct, 1 + d_rank, 0))
    return lat.to(torch.int32)


def pool_plan(cfg: KVBankConfig, pool: PooledKV,
              length: Optional[torch.Tensor] = None) -> ReadPlan:
    """Shared read plan for every layer of a pooled decode step."""
    fresh = pool.parity_fresh if pool_coded(pool) else None
    return _plan_from_tables(cfg, pool.page_table,
                             pool.length if length is None else length, fresh)


def pool_install(cfg: KVBankConfig, pool: PooledKV, slot_i: int,
                 k_seq: torch.Tensor, v_seq: torch.Tensor,
                 fuse_encode: bool = False) -> PooledKV:
    """Install a prefilled prompt's (L, T, Hkv, D) K/V into sequence slot
    ``slot_i``, whose page-table row was assigned on the host. Sets its
    length to T and marks every touched parity row stale.
    ``fuse_encode=True`` also delta-maintains the pair parity for every
    written token (same two-pass scatter as ``pool_write_layer_fused``)."""
    ku = _as(k_seq, pool.k_banks.dtype)
    vu = _as(v_seq, pool.v_banks.dtype)
    t = k_seq.shape[1]
    j = torch.arange(t, device=ku.device)
    phys = pool.page_table[slot_i, j // cfg.page].long()
    # analysis: host-sync at admission: the prompt's assigned pages
    rows = torch.nonzero(phys >= 0).squeeze(1)
    bank = phys[rows] % cfg.n_banks
    slot = phys[rows] // cfg.n_banks
    in_page = rows % cfg.page
    ku, vu = ku[:, rows], vu[:, rows]
    if fuse_encode and pool_coded(pool):
        dk = pool.k_banks[:, bank, slot, in_page] ^ ku   # (L, n, Hkv, D)
        dv = pool.v_banks[:, bank, slot, in_page] ^ vu
        for phase in (0, 1):
            # analysis: host-sync at admission: each parity phase's lanes
            sel = torch.nonzero(bank % 2 == phase).squeeze(1)
            g, s, ip = bank[sel] // 2, slot[sel], in_page[sel]
            pool.k_par[:, g, s, ip] = pool.k_par[:, g, s, ip] ^ dk[:, sel]
            pool.v_par[:, g, s, ip] = pool.v_par[:, g, s, ip] ^ dv[:, sel]
    pool.k_banks[:, bank, slot, in_page] = ku
    pool.v_banks[:, bank, slot, in_page] = vu
    pool.length[slot_i] = t
    if pool_coded(pool):
        pool.parity_fresh[bank // 2, slot] = False
    return pool


def _budget_rows(parity_fresh: torch.Tensor, budget: int):
    """The first ``budget`` stale parity rows in raster order:
    ``(take, idx, valid)`` — the taken-row mask, the flat (group*slots)
    indices of up to ``min(budget, rows)`` rows, and which of them are
    really taken. ``repro``'s version relies on jnp.argsort being stable."""
    ng, slots = parity_fresh.shape
    stale = ~parity_fresh
    order = torch.cumsum(stale.reshape(-1).long(), 0).reshape(stale.shape)
    take = stale & (order <= budget)
    cap = max(0, min(int(budget), ng * slots))
    flat_take = take.reshape(-1)
    key = torch.where(flat_take, order.reshape(-1),
                      torch.iinfo(torch.int32).max)
    idx = torch.argsort(key, stable=True)[:cap]
    return take, idx, flat_take[idx]


def pool_recode(cfg: KVBankConfig, pool: PooledKV,
                budget: Optional[int] = None):
    """ReCoding over the shared status table (all layers of a stale row
    refresh together), in place. Returns ``(pool, n_recoded)``;
    ``budget < 0`` disables recoding, ``None`` refreshes every row."""
    if not pool_coded(pool) or (budget is not None and budget < 0):
        return pool, torch.zeros((), dtype=torch.int64,
                                 device=pool.length.device)
    fresh = pool.parity_fresh
    if budget is None:
        n = (~fresh).sum()
        torch.bitwise_xor(pool.k_banks[:, 0::2], pool.k_banks[:, 1::2],
                          out=pool.k_par)
        torch.bitwise_xor(pool.v_banks[:, 0::2], pool.v_banks[:, 1::2],
                          out=pool.v_par)
        fresh.fill_(True)
        return pool, n
    take, idx, valid = _budget_rows(fresh, budget)
    n = take.sum()
    idx = idx[valid]
    if idx.numel():
        ng, slots = fresh.shape
        g, s = idx // slots, idx % slots
        for banks, par in ((pool.k_banks, pool.k_par),
                           (pool.v_banks, pool.v_par)):
            flat = par.view(par.shape[0], ng * slots, *par.shape[3:])
            flat[:, idx] = banks[:, 2 * g, s] ^ banks[:, 2 * g + 1, s]
    fresh |= take
    return pool, n


def pool_permute(cfg: KVBankConfig, pool: PooledKV,
                 perm: torch.Tensor) -> PooledKV:
    """Relocate physical pages: page p moves to physical id ``perm[p]``
    (churned free-list placement, or a defrag pass). Page tables are
    remapped and parity fully rebuilt, so decode output is invariant.
    Every tensor is rewritten in place."""
    perm = perm.long()

    def move(banks):
        x = banks.movedim(1, 2)                      # (L, slots, NB, ...)
        flat = x.reshape(x.shape[0], -1, *x.shape[3:])  # phys p = slot*NB+bank
        y = torch.zeros_like(flat)
        y[:, perm] = flat
        banks.copy_(y.reshape(x.shape).movedim(2, 1))

    pt = pool.page_table
    pt.copy_(torch.where(pt >= 0, perm[pt.long().clamp(min=0)], -1))
    move(pool.k_banks)
    move(pool.v_banks)
    if pool_coded(pool):
        pool_recode(cfg, pool, budget=None)
    return pool
