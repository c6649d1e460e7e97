"""Observability of the serving path (``repro/obs/serve.py``
counterpart), in two halves:

* device planes (``ServeTelemetry``): counters updated inside the pooled
  decode step: per-bank load histograms, direct vs degraded reads by home
  bank, per-port critical-word latency log2 histograms, the stale-parity
  backlog and the coded vs uncoded port cycles. Telemetry off is a
  ``None`` leaf in the serve cache, and the step then does no extra work.
  The JAX package's counters are uint32; here they are int64 tensors of
  the same values. JAX's ``mode="drop"`` scatter-adds become flat buffers
  with one sink entry that is sliced off.
* host spans (``ServeLog``): per-request lifecycle events, recorded by the
  server.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.obs.planes import HIST_BINS, lat_bin

# Chrome-trace thread ids of the serving rows
TID_SERVE_QUEUE = 10       # admission waits
TID_SERVE_SLOT0 = 11       # decode slots: TID_SERVE_SLOT0 + slot index


class ServeTelemetry(NamedTuple):
    """Device-side serving metric planes (int64 tensors)."""
    bank_load_hist: torch.Tensor   # (NB, HIST_BINS) per-step load histogram
    read_mode_bank: torch.Tensor   # (NB, 2) [direct, degraded] by home bank
    port_lat_hist: torch.Tensor    # (NB, HIST_BINS) critical-word latency,
    #                                attributed to the port that served it
    stale_backlog: torch.Tensor    # () post-recode stale-row integral
    stale_hwm: torch.Tensor        # () stale-row high-water mark
    recoded_rows: torch.Tensor     # () rows the ReCoding unit refreshed
    decode_steps: torch.Tensor     # ()
    appended_tokens: torch.Tensor  # ()
    uncoded_cycles: torch.Tensor   # () sum of per-step uncoded port cycles
    coded_cycles: torch.Tensor     # () sum of per-step coded port cycles


def init_serve_telemetry(n_banks: int, device) -> ServeTelemetry:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=device)
    return ServeTelemetry(
        bank_load_hist=z(n_banks, HIST_BINS), read_mode_bank=z(n_banks, 2),
        port_lat_hist=z(n_banks, HIST_BINS), stale_backlog=z(),
        stale_hwm=z(), recoded_rows=z(), decode_steps=z(),
        appended_tokens=z(), uncoded_cycles=z(), coded_cycles=z())


def _add_counts(plane: torch.Tensor, flat_idx: torch.Tensor) -> None:
    """``plane.view(-1)[i] += 1`` for every ``i`` in ``flat_idx``; the
    index ``plane.numel()`` is the sink and is dropped."""
    buf = torch.zeros(plane.numel() + 1, dtype=plane.dtype,
                      device=plane.device)
    idx = flat_idx.reshape(-1)
    buf.scatter_add_(0, idx, torch.ones_like(idx, dtype=plane.dtype))
    plane.view(-1).add_(buf[:-1])


def update_serve_telemetry(tele: ServeTelemetry, *, load, needed, bank,
                           use_parity, latencies, stale_before, recoded,
                           appended, uncoded_cycles,
                           coded_cycles) -> ServeTelemetry:
    """Fold one pooled decode step's plan into the planes, in place
    (``repro/obs/serve.py:70``). No host sync."""
    nb = tele.bank_load_hist.shape[0]
    sink = nb * HIST_BINS
    use_parity = use_parity.bool()
    bank = bank.long()
    direct = needed & ~use_parity
    deg = needed & use_parity
    rows = torch.arange(nb, device=load.device)
    _add_counts(tele.bank_load_hist, rows * HIST_BINS + lat_bin(load.long()))
    _add_counts(tele.read_mode_bank,
                torch.cat([torch.where(direct, bank * 2, 2 * nb).reshape(-1),
                           torch.where(deg, bank * 2 + 1, 2 * nb)
                           .reshape(-1)]))
    port = torch.where(deg, bank ^ 1, bank)
    _add_counts(tele.port_lat_hist,
                torch.where(needed, port * HIST_BINS
                            + lat_bin(latencies.long()), sink))
    sb = stale_before.long()
    rc = recoded.long()
    tele.stale_backlog.add_(sb - rc)
    torch.maximum(tele.stale_hwm, sb, out=tele.stale_hwm)
    tele.recoded_rows.add_(rc)
    tele.decode_steps.add_(1)
    tele.appended_tokens.add_(appended.long())
    tele.uncoded_cycles.add_(uncoded_cycles.long())
    tele.coded_cycles.add_(coded_cycles.long())
    return tele


class ServeSnapshot:
    """Host-side view of the serving planes with derived aggregates."""

    def __init__(self, tele: ServeTelemetry):
        def host(t):
            return t.detach().cpu().numpy().astype(np.int64)
        self.bank_load_hist = host(tele.bank_load_hist)
        self.read_mode_bank = host(tele.read_mode_bank)
        self.port_lat_hist = host(tele.port_lat_hist)
        self.stale_backlog = int(tele.stale_backlog)
        self.stale_hwm = int(tele.stale_hwm)
        self.recoded_rows = int(tele.recoded_rows)
        self.decode_steps = int(tele.decode_steps)
        self.appended_tokens = int(tele.appended_tokens)
        self.uncoded_cycles = int(tele.uncoded_cycles)
        self.coded_cycles = int(tele.coded_cycles)

    # ------------------------------------------------------------ derived
    @property
    def direct_reads(self) -> int:
        return int(self.read_mode_bank[:, 0].sum())

    @property
    def degraded_reads(self) -> int:
        return int(self.read_mode_bank[:, 1].sum())

    @property
    def served_pages(self) -> int:
        return self.direct_reads + self.degraded_reads

    @property
    def cycles_saved(self) -> int:
        return self.uncoded_cycles - self.coded_cycles

    def as_dict(self) -> Dict:
        return {
            "bank_load_hist": self.bank_load_hist.tolist(),
            "read_mode_bank": self.read_mode_bank.tolist(),
            "port_lat_hist": self.port_lat_hist.tolist(),
            "stale_backlog": self.stale_backlog,
            "stale_hwm": self.stale_hwm,
            "recoded_rows": self.recoded_rows,
            "decode_steps": self.decode_steps,
            "appended_tokens": self.appended_tokens,
            "uncoded_cycles": self.uncoded_cycles,
            "coded_cycles": self.coded_cycles,
            "direct_reads": self.direct_reads,
            "degraded_reads": self.degraded_reads,
            "served_pages": self.served_pages,
            "cycles_saved": self.cycles_saved,
        }

    def check_against(self, totals) -> None:
        """Exact conformance against an independent recompute with the
        same plane and counter names (``repro_torch.oracle.kvpool.
        PlaneTotals``, or the JAX package's); raises AssertionError on the
        first disagreeing counter."""
        for field in ("bank_load_hist", "read_mode_bank", "port_lat_hist"):
            dev, exp = getattr(self, field), getattr(totals, field)
            if not np.array_equal(dev, np.asarray(exp)):
                raise AssertionError(
                    f"serve plane {field!r} disagrees with the recompute:"
                    f"\ndevice=\n{dev}\nrecompute=\n{exp}")
        for field in ("stale_backlog", "stale_hwm", "recoded_rows",
                      "decode_steps", "appended_tokens", "uncoded_cycles",
                      "coded_cycles"):
            dev, exp = getattr(self, field), int(getattr(totals, field))
            if dev != exp:
                raise AssertionError(
                    f"serve counter {field!r}: device={dev} recompute={exp}")


def snapshot(tele: ServeTelemetry) -> ServeSnapshot:
    return ServeSnapshot(tele)


def format_summary(snap: ServeSnapshot) -> str:
    """One-paragraph console summary (used by launch/serve.py)."""
    lines = [
        f"serve planes: {snap.decode_steps} decode steps, "
        f"{snap.appended_tokens} tokens appended, "
        f"{snap.served_pages} page reads "
        f"({snap.degraded_reads} degraded)",
        f"  port cycles: coded {snap.coded_cycles} vs uncoded "
        f"{snap.uncoded_cycles} (saved {snap.cycles_saved})",
        f"  recode: {snap.recoded_rows} rows refreshed, backlog integral "
        f"{snap.stale_backlog}, high-water {snap.stale_hwm} stale rows",
    ]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Host-side request lifecycle spans
# ---------------------------------------------------------------------------

class _Req:
    __slots__ = ("rid", "submit", "admit", "prefill_done", "slot",
                 "prompt_len", "tokens", "finish")

    def __init__(self, rid, now):
        self.rid = rid
        self.submit = now
        self.admit = None
        self.prefill_done = None
        self.slot = None
        self.prompt_len = 0
        self.tokens: List[float] = []   # decode-token completion times
        self.finish = None


class ServeLog:
    """Per-request lifecycle spans (queued -> prefill -> decode slot ->
    finished), recorded on the host by the server. The clock is injectable
    so tests can drive it; the default is ``time.perf_counter``."""

    def __init__(self, clock=None):
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        self._reqs: Dict[int, _Req] = {}

    def _now(self) -> float:
        return self._clock() - self._t0

    def _get(self, rid: int) -> _Req:
        if rid not in self._reqs:
            self._reqs[rid] = _Req(rid, self._now())
        return self._reqs[rid]

    # ------------------------------------------------------------- events
    def submit(self, rid: int) -> None:
        self._reqs[rid] = _Req(rid, self._now())

    def admit(self, rid: int, slot: int, prompt_len: int) -> None:
        r = self._get(rid)
        r.admit, r.slot, r.prompt_len = self._now(), slot, prompt_len

    def prefill_done(self, rid: int) -> None:
        self._get(rid).prefill_done = self._now()

    def token(self, rid: int) -> None:
        self._get(rid).tokens.append(self._now())

    def finish(self, rid: int) -> None:
        self._get(rid).finish = self._now()

    # ------------------------------------------------------------ queries
    def spans(self) -> List[Dict]:
        out = []
        for r in sorted(self._reqs.values(), key=lambda r: r.rid):
            ticks = ([r.prefill_done] if r.prefill_done is not None else []) \
                + r.tokens
            out.append({
                "rid": r.rid, "slot": r.slot, "prompt_len": r.prompt_len,
                "submit_s": r.submit, "admit_s": r.admit,
                "finish_s": r.finish,
                "admission_wait_s":
                    None if r.admit is None else r.admit - r.submit,
                "ttft_s": None if r.prefill_done is None
                    else r.prefill_done - r.submit,
                "n_tokens": len(ticks),
                "inter_token_s": [b - a for a, b in zip(ticks, ticks[1:])],
            })
        return out

    def summary(self, rids=None) -> Dict:
        """Request counts and latency percentiles, over ``rids`` (default:
        every request seen)."""
        spans = [s for s in self.spans() if rids is None or s["rid"] in rids]
        ttfts = [s["ttft_s"] for s in spans if s["ttft_s"] is not None]
        waits = [s["admission_wait_s"] for s in spans
                 if s["admission_wait_s"] is not None]
        itl = [x for s in spans for x in s["inter_token_s"]]

        def pct(xs, q):
            return float(np.percentile(np.asarray(xs), q)) if xs else None

        return {
            "requests": len(spans),
            "finished": sum(s["finish_s"] is not None for s in spans),
            "tokens": sum(s["n_tokens"] for s in spans),
            "ttft_p50_s": pct(ttfts, 50), "ttft_p99_s": pct(ttfts, 99),
            "admission_wait_p50_s": pct(waits, 50),
            "inter_token_p50_s": pct(itl, 50),
            "inter_token_p99_s": pct(itl, 99),
        }

    # ------------------------------------------------------ chrome export
    def to_chrome_events(self) -> List[Dict]:
        """Chrome-trace rows: one "queue" row plus one row per slot."""
        us = 1e6
        ev: List[Dict] = [
            {"name": "thread_name", "ph": "M", "pid": 0,
             "tid": TID_SERVE_QUEUE, "args": {"name": "serve queue"}},
        ]
        slots = sorted({r.slot for r in self._reqs.values()
                        if r.slot is not None})
        for s in slots:
            ev.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": TID_SERVE_SLOT0 + s,
                       "args": {"name": f"serve slot {s}"}})
        for r in sorted(self._reqs.values(), key=lambda r: r.rid):
            if r.admit is not None:
                ev.append({"name": f"queued req {r.rid}", "ph": "X",
                           "pid": 0, "tid": TID_SERVE_QUEUE,
                           "ts": r.submit * us,
                           "dur": (r.admit - r.submit) * us,
                           "args": {"rid": r.rid}})
            if r.admit is None or r.slot is None:
                continue
            end = r.finish if r.finish is not None else (
                r.tokens[-1] if r.tokens else r.admit)
            ev.append({"name": f"req {r.rid}", "ph": "X", "pid": 0,
                       "tid": TID_SERVE_SLOT0 + r.slot, "ts": r.admit * us,
                       "dur": (end - r.admit) * us,
                       "args": {"rid": r.rid, "prompt_len": r.prompt_len,
                                "n_tokens": len(r.tokens) + 1}})
            if r.prefill_done is not None:
                ev.append({"name": f"first token req {r.rid}", "ph": "i",
                           "pid": 0, "tid": TID_SERVE_SLOT0 + r.slot,
                           "ts": r.prefill_done * us, "s": "t"})
        return ev

    def export_chrome_trace(self, path: str,
                            manifest: Optional[Dict] = None) -> str:
        """Write the rows as a Perfetto-loadable Chrome-trace JSON file."""
        blob = {"traceEvents": self.to_chrome_events(),
                "displayTimeUnit": "ms",
                "otherData": {"manifest": manifest or {}}}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(blob, f, default=float)
        return path
