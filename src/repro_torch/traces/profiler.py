"""Streaming trace locality profiler (the paper's Fig 15 observation),
port of ``repro/traces/profiler.py`` (numpy only, as there).

The paper's dynamic-coding results hinge on one empirical property of the
gem5/PARSEC traces: accesses "occupy consistent bands of sequential memory
addresses" (Fig 15) — persistent contiguous row intervals that a small
coded-region budget can cover. ``TraceProfiler`` measures exactly that,
streaming (chunk at a time, O(n_rows) state, never materializing the trace):

* per-bank / per-row access histograms and the read/write mix,
* **windowed band detection**: time is cut into fixed-size request windows;
  a coarse row-bin is *present* in a window when it receives at least one
  access, and a band is a maximal run of bins present in at least a
  ``min_persistence`` fraction of windows — "consistent" in the paper's
  sense, not merely hot in aggregate (a drifting hot spot paints many bins,
  each in few windows, and is rejected),
* burstiness: the Fano factor (variance/mean) of per-window per-bank
  request counts — >1 means requests clump onto banks in bursts (the
  conflict pattern multi-port memory exists for),
* ``region_priors``: the row histogram aggregated to dynamic-coding regions
  and ranked — the warm-start selection ``CodedMemorySystem.init`` /
  ``repro_torch.traces.stream_replay(region_priors=...)`` feed to the
  dynamic coding unit (``repro_torch.core.dynamic.priors_layout``).

Chunks may hold tensors on any device or numpy arrays; they are read to
the host once per ``update``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import numpy as np

from repro_torch.core.system import Trace
from repro_torch.traces.source import host_arrays


@dataclasses.dataclass(frozen=True)
class Band:
    """One detected address band, in row coordinates."""

    row_lo: int        # first row of the band (inclusive)
    row_hi: int        # last row of the band (inclusive)
    weight: float      # fraction of all accesses landing in the band
    persistence: float  # fraction of windows the band's bins were present in

    @property
    def center(self) -> float:
        return (self.row_lo + self.row_hi) / 2


@dataclasses.dataclass(frozen=True)
class TraceProfile:
    """Aggregated statistics; derived views are methods (host-side numpy)."""

    n_banks: int
    n_rows: int
    n_requests: int
    reads: int
    writes: int
    bank_hist: np.ndarray      # (n_banks,) int64
    row_hist: np.ndarray       # (n_rows,) int64
    n_windows: int
    window: int                # requests per window
    bin_rows: int              # rows per coarse presence bin
    presence: np.ndarray       # (n_bins,) int64 — windows each bin was hit in
    bank_window_mean: np.ndarray  # (n_banks,) per-window mean request count
    bank_window_var: np.ndarray   # (n_banks,) per-window variance

    # ------------------------------------------------------------------ mix
    @property
    def write_frac(self) -> float:
        return self.writes / max(self.n_requests, 1)

    @property
    def burstiness(self) -> float:
        """Mean per-bank Fano factor of windowed request counts (1 ≈
        Poisson; larger = bursty bank conflicts)."""
        mean = np.maximum(self.bank_window_mean, 1e-12)
        return float(np.mean(self.bank_window_var / mean))

    # ---------------------------------------------------------------- bands
    def bands(self, min_persistence: float = 0.5,
              min_weight: float = 0.02, max_gap_bins: int = 1) -> List[Band]:
        """Consistent address bands (Fig 15): maximal runs of coarse row
        bins present in ≥ ``min_persistence`` of windows, gaps up to
        ``max_gap_bins`` bridged, runs carrying < ``min_weight`` of total
        traffic dropped."""
        if self.n_windows == 0:
            return []
        frac = self.presence / self.n_windows
        consistent = frac >= min_persistence
        bands: List[Band] = []
        total = max(self.row_hist.sum(), 1)
        i, n = 0, consistent.size
        while i < n:
            if not consistent[i]:
                i += 1
                continue
            j = i
            gap = 0
            k = i + 1
            while k < n and gap <= max_gap_bins:
                if consistent[k]:
                    j, gap = k, 0
                else:
                    gap += 1
                k += 1
            lo = i * self.bin_rows
            hi = min((j + 1) * self.bin_rows, self.n_rows) - 1
            w = float(self.row_hist[lo:hi + 1].sum() / total)
            if w >= min_weight:
                bands.append(Band(lo, hi, w,
                                  float(frac[i:j + 1].mean())))
            i = j + 1
        return bands

    # ----------------------------------------------------------- region feed
    def region_priors(self, region_size: int, n_regions: int,
                      k: Optional[int] = None) -> np.ndarray:
        """Ranked hot regions for the dynamic coding unit: the row histogram
        aggregated per region (the same ``row // region_size`` binning the
        controller's ``access_count`` uses), hottest first, zero-traffic
        regions excluded, -1 padded to ``k`` entries."""
        counts = np.zeros(n_regions, np.int64)
        idx = np.arange(self.n_rows) // region_size
        np.add.at(counts, np.minimum(idx, n_regions - 1), self.row_hist)
        order = np.argsort(-counts, kind="stable")
        order = order[counts[order] > 0]
        if k is not None:
            out = np.full(k, -1, np.int32)
            out[:min(k, order.size)] = order[:min(k, order.size)]
            return out
        return order.astype(np.int32)


class TraceProfiler:
    """Streaming accumulator: feed chunks with ``update``, read a
    ``TraceProfile`` with ``profile`` at any point."""

    def __init__(self, n_banks: int, n_rows: int, window: int = 512,
                 bin_rows: Optional[int] = None):
        self.n_banks = n_banks
        self.n_rows = n_rows
        self.window = max(int(window), 1)
        # coarse presence bins: fine enough to resolve paper-width bands
        # (~3% of the row space), coarse enough that per-window presence
        # is dense inside a band
        self.bin_rows = bin_rows if bin_rows is not None else max(
            n_rows // 128, 1)
        self._n_bins = -(-n_rows // self.bin_rows)
        self.bank_hist = np.zeros(n_banks, np.int64)
        self.row_hist = np.zeros(n_rows, np.int64)
        self.reads = 0
        self.writes = 0
        self.n_requests = 0
        self.n_windows = 0
        self.presence = np.zeros(self._n_bins, np.int64)
        # windowed per-bank counts for burstiness (Welford over windows)
        self._bw_mean = np.zeros(n_banks)
        self._bw_m2 = np.zeros(n_banks)
        # carry of an incomplete window across update() calls
        self._pend_rows: List[np.ndarray] = []
        self._pend_banks: List[np.ndarray] = []
        self._pend_n = 0

    # ------------------------------------------------------------- streaming
    def update(self, chunk: Trace) -> "TraceProfiler":
        """Accumulate one chunk. Requests are taken in arrival order
        (time-major: all cores' cycle t before cycle t+1), matching the
        order the cycle engine's core arbiter consumes them."""
        bank, row, isw, _, valid = host_arrays(chunk)
        # time-major flatten, masked to real requests
        v = valid.T.reshape(-1)
        b = bank.T.reshape(-1)[v]
        r = row.T.reshape(-1)[v]
        w = isw.T.reshape(-1)[v]
        np.add.at(self.bank_hist, b, 1)
        np.add.at(self.row_hist, r, 1)
        self.writes += int(w.sum())
        self.reads += int(v.sum()) - int(w.sum())
        self.n_requests += int(v.sum())
        self._pend_rows.append(r)
        self._pend_banks.append(b)
        self._pend_n += r.size
        while self._pend_n >= self.window:
            rows = np.concatenate(self._pend_rows) if len(self._pend_rows) > 1 \
                else self._pend_rows[0]
            banks = np.concatenate(self._pend_banks) if len(self._pend_banks) > 1 \
                else self._pend_banks[0]
            self._consume_window(rows[:self.window], banks[:self.window])
            self._pend_rows = [rows[self.window:]]
            self._pend_banks = [banks[self.window:]]
            self._pend_n -= self.window
        return self

    def _consume_window(self, rows: np.ndarray, banks: np.ndarray):
        self.n_windows += 1
        bins = np.zeros(self._n_bins, bool)
        bins[rows // self.bin_rows] = True
        self.presence += bins
        counts = np.bincount(banks, minlength=self.n_banks).astype(float)
        d = counts - self._bw_mean
        self._bw_mean += d / self.n_windows
        self._bw_m2 += d * (counts - self._bw_mean)

    def profile(self) -> TraceProfile:
        var = (self._bw_m2 / max(self.n_windows - 1, 1)
               if self.n_windows > 1 else np.zeros(self.n_banks))
        return TraceProfile(
            n_banks=self.n_banks, n_rows=self.n_rows,
            n_requests=self.n_requests, reads=self.reads, writes=self.writes,
            bank_hist=self.bank_hist.copy(), row_hist=self.row_hist.copy(),
            n_windows=self.n_windows, window=self.window,
            bin_rows=self.bin_rows, presence=self.presence.copy(),
            bank_window_mean=self._bw_mean.copy(), bank_window_var=var)


def profile_trace(trace_or_chunks, n_banks: int, n_rows: int,
                  window: int = 512,
                  bin_rows: Optional[int] = None) -> TraceProfile:
    """One-call profiling of a Trace or an iterable of Trace chunks."""
    prof = TraceProfiler(n_banks, n_rows, window=window, bin_rows=bin_rows)
    chunks: Iterable[Trace] = ([trace_or_chunks]
                               if isinstance(trace_or_chunks, Trace)
                               else trace_or_chunks)
    for chunk in chunks:
        prof.update(chunk)
    return prof.profile()
