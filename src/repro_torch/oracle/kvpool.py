"""Golden model for the serving KV pool: plan, latency, and telemetry
recompute in plain NumPy + Python loops (a copy of the JAX package's
``oracle/kvpool.py``, which the port may not import; the tests hold the
two equal field for field).

``runtime/kvbank.py`` builds its read plans and critical-word latencies with
vectorized one-hot/cumsum tricks on the device; this module re-derives every
number the serving telemetry plane reports with the dumbest possible
sequential walk, so the two implementations cannot share a misconception.
``repro_torch.obs.report --serve`` refuses to render any metric that
disagrees with this recompute.

Model (mirrors kvbank's contract, derived from the paper's §IV controller):

* physical page ``p`` lives in bank ``p % n_banks``, slot ``p // n_banks``;
  parity group ``g`` protects banks ``(2g, 2g+1)`` on its own port.
* a decode step reads every allocated logical page of every active
  sequence once; requests are ordered batch-major over ``(B, max_pages)``.
* for each bank hotter than its pair sibling, every second fresh-parity
  read (ranks 1, 3, … below ``2 * ⌊(load−sib)/2⌋``) goes degraded.
* each bank port serves its direct reads first in request order, then
  lends cycles to its sibling's degraded reads; each parity port serves
  its group's degraded reads in request order. A degraded read completes
  when both words have arrived.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

HIST_BINS = 16  # matches repro_torch.obs.planes.HIST_BINS


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def lat_bin(lat: int) -> int:
    """log2 histogram bin: 0 → 0, otherwise 1 + floor(log2(lat))."""
    return min(int(lat).bit_length(), HIST_BINS - 1)


def page_requests(n_banks: int, page: int, page_table: np.ndarray,
                  length: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """This step's page reads in request (batch-major) order:
    ``[(seq, logical_page, bank, slot), ...]``."""
    out = []
    for b in range(page_table.shape[0]):
        for m in range(ceil_div(int(length[b]), page)):
            phys = int(page_table[b, m])
            if phys >= 0:
                out.append((b, m, phys % n_banks, phys // n_banks))
    return out


def plan_reads(n_banks: int, page: int, page_table: np.ndarray,
               length: np.ndarray,
               parity_fresh: Optional[np.ndarray]) -> dict:
    """Re-derive the controller's degraded-read plan sequentially."""
    reqs = page_requests(n_banks, page, page_table, length)
    load = np.zeros(n_banks, np.int64)
    for _, _, bank, _ in reqs:
        load[bank] += 1
    k_bank = np.maximum(load - load[np.arange(n_banks) ^ 1], 0) // 2

    use_parity = np.zeros(page_table.shape, bool)
    rank = np.zeros(n_banks, np.int64)      # fresh-parity requests seen so far
    for b, m, bank, slot in reqs:
        fresh = parity_fresh is not None and bool(parity_fresh[bank // 2, slot])
        if not fresh:
            continue
        r, rank[bank] = rank[bank], rank[bank] + 1
        if r % 2 == 1 and r < 2 * k_bank[bank]:
            use_parity[b, m] = True

    d_load = np.zeros(n_banks, np.int64)    # direct reads per bank port
    s_load = np.zeros(n_banks, np.int64)    # degraded shares per sibling port
    p_load = np.zeros(n_banks // 2, np.int64)
    for b, m, bank, _ in reqs:
        if use_parity[b, m]:
            s_load[bank ^ 1] += 1
            p_load[bank // 2] += 1
        else:
            d_load[bank] += 1
    coded = max(int(np.max(d_load + s_load)), int(np.max(p_load))) \
        if reqs else 0
    return {"load": load, "use_parity": use_parity,
            "uncoded_cycles": int(np.max(load)) if reqs else 0,
            "coded_cycles": coded}


def read_latencies(n_banks: int, page: int, page_table: np.ndarray,
                   length: np.ndarray, use_parity: np.ndarray) -> np.ndarray:
    """Critical-word latency per page read, sequential port walk."""
    reqs = page_requests(n_banks, page, page_table, length)
    d_count = np.zeros(n_banks, np.int64)
    for b, m, bank, _ in reqs:
        if not use_parity[b, m]:
            d_count[bank] += 1

    lat = np.zeros(page_table.shape, np.int64)
    d_next = np.zeros(n_banks, np.int64)         # direct cycles handed out
    s_next = d_count.copy()                      # sibling port cursor
    p_next = np.zeros(n_banks // 2, np.int64)    # parity port cursor
    for b, m, bank, _ in reqs:
        if use_parity[b, m]:
            sib, grp = bank ^ 1, bank // 2
            s_next[sib] += 1
            p_next[grp] += 1
            lat[b, m] = max(int(s_next[sib]), int(p_next[grp]))
        else:
            d_next[bank] += 1
            lat[b, m] = int(d_next[bank])
    return lat


def write_targets(n_banks: int, page: int, page_table: np.ndarray,
                  length: np.ndarray,
                  active: np.ndarray) -> List[Tuple[int, int, int]]:
    """(seq, bank, slot) for this step's one-token appends."""
    out = []
    max_pages = page_table.shape[1]
    for b in range(page_table.shape[0]):
        if not active[b]:
            continue
        lpage = int(length[b]) // page
        if lpage >= max_pages:
            continue
        phys = int(page_table[b, lpage])
        if phys >= 0:
            out.append((b, phys % n_banks, phys // n_banks))
    return out


def recode_select(parity_fresh: np.ndarray,
                  budget: Optional[int]) -> np.ndarray:
    """Rows the budgeted ReCoding walk refreshes this step (row-major
    order over the status table, first ``budget`` stale rows)."""
    stale = ~parity_fresh
    if budget is None:
        return stale
    if budget < 0:
        return np.zeros_like(stale)
    take = np.zeros_like(stale)
    left = budget
    for g in range(stale.shape[0]):
        for s in range(stale.shape[1]):
            if stale[g, s] and left > 0:
                take[g, s] = True
                left -= 1
    return take


@dataclasses.dataclass
class StepExpectation:
    """Every serving-plane increment one decode step should produce."""
    appended: int
    load: np.ndarray                 # (NB,)
    use_parity: np.ndarray           # (B, MP) bool
    latencies: np.ndarray            # (B, MP)
    uncoded_cycles: int
    coded_cycles: int
    bank_load_bins: np.ndarray       # (NB, HIST_BINS)
    read_mode_bank: np.ndarray       # (NB, 2) direct / degraded by home bank
    port_lat_hist: np.ndarray        # (NB, HIST_BINS) by serving port
    stale_before: int                # after this step's writes, before recode
    recoded: int
    parity_fresh_after: Optional[np.ndarray]


def expected_step(n_banks: int, page: int, page_table: np.ndarray,
                  length: np.ndarray, parity_fresh: Optional[np.ndarray],
                  active: np.ndarray,
                  recode_budget: Optional[int] = None) -> StepExpectation:
    """Replay one pooled decode step on the host: write marks → plan →
    latencies → recode, returning the exact plane increments."""
    page_table = np.asarray(page_table)
    length = np.asarray(length)
    active = np.asarray(active)
    writes = write_targets(n_banks, page, page_table, length, active)

    fresh = None
    if parity_fresh is not None:
        fresh = np.array(parity_fresh, copy=True)
        for _, bank, slot in writes:
            fresh[bank // 2, slot] = False

    len_eff = length + active.astype(length.dtype)
    plan = plan_reads(n_banks, page, page_table, len_eff, fresh)
    lat = read_latencies(n_banks, page, page_table, len_eff,
                         plan["use_parity"])

    bank_load_bins = np.zeros((n_banks, HIST_BINS), np.int64)
    for bank in range(n_banks):
        bank_load_bins[bank, lat_bin(int(plan["load"][bank]))] += 1
    read_mode = np.zeros((n_banks, 2), np.int64)
    port_hist = np.zeros((n_banks, HIST_BINS), np.int64)
    for b, m, bank, _ in page_requests(n_banks, page, page_table, len_eff):
        deg = bool(plan["use_parity"][b, m])
        read_mode[bank, 1 if deg else 0] += 1
        port_hist[bank ^ 1 if deg else bank, lat_bin(int(lat[b, m]))] += 1

    stale_before = recoded = 0
    fresh_after = fresh
    if fresh is not None:
        stale_before = int(np.sum(~fresh))
        take = recode_select(fresh, recode_budget)
        recoded = int(np.sum(take))
        fresh_after = fresh | take
    return StepExpectation(
        appended=len(writes), load=plan["load"],
        use_parity=plan["use_parity"], latencies=lat,
        uncoded_cycles=plan["uncoded_cycles"],
        coded_cycles=plan["coded_cycles"],
        bank_load_bins=bank_load_bins, read_mode_bank=read_mode,
        port_lat_hist=port_hist, stale_before=stale_before,
        recoded=recoded, parity_fresh_after=fresh_after)


@dataclasses.dataclass
class PlaneTotals:
    """Accumulated expectations over a run — compare against a
    ``repro_torch.obs.serve`` snapshot field-by-field, exactly."""
    bank_load_hist: np.ndarray
    read_mode_bank: np.ndarray
    port_lat_hist: np.ndarray
    stale_backlog: int = 0
    stale_hwm: int = 0
    recoded_rows: int = 0
    decode_steps: int = 0
    appended_tokens: int = 0
    uncoded_cycles: int = 0
    coded_cycles: int = 0

    def add(self, e: StepExpectation) -> None:
        self.bank_load_hist += e.bank_load_bins
        self.read_mode_bank += e.read_mode_bank
        self.port_lat_hist += e.port_lat_hist
        self.stale_backlog += e.stale_before - e.recoded
        self.stale_hwm = max(self.stale_hwm, e.stale_before)
        self.recoded_rows += e.recoded
        self.decode_steps += 1
        self.appended_tokens += e.appended
        self.uncoded_cycles += e.uncoded_cycles
        self.coded_cycles += e.coded_cycles


def plane_totals(n_banks: int) -> PlaneTotals:
    return PlaneTotals(
        bank_load_hist=np.zeros((n_banks, HIST_BINS), np.int64),
        read_mode_bank=np.zeros((n_banks, 2), np.int64),
        port_lat_hist=np.zeros((n_banks, HIST_BINS), np.int64))
