"""Host-side request lifecycle spans of the serving path (``ServeLog``,
the counterpart of ``repro/obs/serve.py:167-304``). The device metric
planes (``ServeConfig.telemetry``) are not ported yet."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

# Chrome-trace thread ids of the serving rows
TID_SERVE_QUEUE = 10       # admission waits
TID_SERVE_SLOT0 = 11       # decode slots: TID_SERVE_SLOT0 + slot index


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
