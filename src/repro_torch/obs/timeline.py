"""Scheduler timeline export: replay decisions as Chrome-trace JSON; the
port of ``repro/obs/timeline.py``.

``record_timeline`` runs a workload through ``cycle_fn`` one cycle at a
time (host-stepped: the per-cycle reading is the point, not speed) and
emits what the batched paths fold away: write-drain spans, region encode
spans, switches, recode bursts, per-cycle grants and queue occupancy,
stalled cores and the chunk restage points. The output is the Chrome
trace-event format, for ``chrome://tracing`` or https://ui.perfetto.dev;
one simulated cycle is one microsecond of trace time. It needs no
telemetry planes: every signal is read from ordinary state leaves, with
one host read a cycle.

CLI (on the card unless ``--device`` names another)::

    PYTHONPATH=src python -m repro_torch.obs.timeline --device cpu \\
        --scheme scheme_i --alpha 0.25 --r 0.05 --length 96 \\
        --chunk-len 32 --out experiments/torch/obs/timeline.json
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

# pid/tid layout of the exported trace (Perfetto groups rows by these)
PID = 0
TID_SCHED, TID_DYNAMIC, TID_RECODE, TID_QUEUES = 0, 1, 2, 3
_THREADS = {TID_SCHED: "scheduler", TID_DYNAMIC: "dynamic coding",
            TID_RECODE: "recoding", TID_QUEUES: "queues"}


def _meta_events() -> List[dict]:
    ev = [{"name": "process_name", "ph": "M", "pid": PID,
           "args": {"name": "coded-memory-system"}}]
    for tid, name in _THREADS.items():
        ev.append({"name": "thread_name", "ph": "M", "pid": PID, "tid": tid,
                   "args": {"name": name}})
    return ev


def record_timeline(system, source, *, chunk_len: Optional[int] = None,
                    tn=None, region_priors=None,
                    max_cycles: int = 4096) -> List[dict]:
    """Replay ``source`` through ``system`` (on its device) cycle by
    cycle and return the Chrome-trace events.

    ``source`` is anything ``repro_torch.traces.source.as_source`` takes;
    ``chunk_len`` stages it as ``stream_replay`` does (None: the default
    chunk length). ``max_cycles`` bounds the host-stepped loop."""
    from repro_torch.core.system import quiescent
    from repro_torch.traces.source import as_source
    from repro_torch.traces.stream import DEFAULT_CHUNK_LEN, chunk_bound

    src = as_source(source)
    clen = chunk_len if chunk_len is not None else DEFAULT_CHUNK_LEN
    tn = tn if tn is not None else system.tunables
    st = system.init(tn, region_priors=region_priors)
    bound = chunk_bound(system, clen)
    pos = np.zeros(system.n_cores, np.int64)

    events = _meta_events()
    open_spans: Dict[int, str] = {}     # tid -> open B-span name

    def begin(tid, name, ts, **args):
        open_spans[tid] = name
        events.append({"name": name, "ph": "B", "ts": ts, "pid": PID,
                       "tid": tid, "args": args})

    def end(tid, ts):
        name = open_spans.pop(tid, None)
        if name is not None:
            events.append({"name": name, "ph": "E", "ts": ts, "pid": PID,
                           "tid": tid})

    def instant(tid, name, ts, **args):
        events.append({"name": name, "ph": "i", "s": "t", "ts": ts,
                       "pid": PID, "tid": tid, "args": args})

    def counter(name, ts, values):
        events.append({"name": name, "ph": "C", "ts": ts, "pid": PID,
                       "args": values})

    nc = system.n_cores
    prev_wm, prev_enc, prev_sw, prev_rc = False, -1, 0, 0
    prev_stalls = 0
    total_cycles = 0
    while total_cycles < max_cycles:
        chunk, stream_end = src.stage(pos, clen, system.device)
        st = st._replace(core_ptr=torch.zeros_like(st.core_ptr))
        staged = stream_end.cpu().numpy().astype(np.int64)
        instant(TID_SCHED, "chunk restage", int(st.mem.cycle),
                pos=[int(x) for x in pos],
                staged=[int(x) for x in np.minimum(staged, clen)])
        tlen = chunk.bank.shape[-1]
        chunk_cycles = 0
        while total_cycles < max_cycles and chunk_cycles < bound:
            st, out = system.cycle_fn(st, chunk, tn, stream_end)
            m = st.mem
            (cyc, wm, enc_region, enc_slot, switches, rc_backlog, n_served,
             rq_occ, wq_occ, stalls, quiet, *ptr) = torch.cat([torch.stack([
                 m.cycle.long(), m.write_mode.long(), m.enc_region.long(),
                 m.enc_slot.long(), m.switches.long(), m.rc_valid.sum(),
                 out.n_served.long(), m.rq_valid.sum(), m.wq_valid.sum(),
                 m.stall_cycles, quiescent(st).long()]),
                 st.core_ptr.long()]).tolist()
            ts = cyc                # post-increment: the cycle just run
            total_cycles += 1
            chunk_cycles += 1
            wm = bool(wm)

            if wm and not prev_wm:
                begin(TID_SCHED, "write drain", ts)
            elif prev_wm and not wm:
                end(TID_SCHED, ts)
            if enc_region >= 0 and prev_enc < 0:
                begin(TID_DYNAMIC, f"encode region {enc_region}", ts,
                      region=enc_region, slot=enc_slot)
            elif prev_enc >= 0 and enc_region < 0:
                end(TID_DYNAMIC, ts)
            if switches > prev_sw:
                instant(TID_DYNAMIC, "region switch", ts, total=switches)
            if rc_backlog < prev_rc:
                instant(TID_RECODE, "recode burst", ts,
                        retired=prev_rc - rc_backlog)
            counter("queue occupancy", ts, {"read": rq_occ,
                                            "write": wq_occ})
            counter("arbiter grants", ts, {"served": n_served})
            counter("recode backlog", ts, {"pending": rc_backlog})
            if stalls != prev_stalls:
                counter("stalled cores", ts,
                        {"stalls": stalls - prev_stalls})
            prev_wm, prev_enc, prev_sw = wm, enc_region, switches
            prev_rc, prev_stalls = rc_backlog, stalls

            starved = bool(np.any((np.asarray(ptr[:nc]) >= tlen)
                                  & (staged > tlen)))
            if starved or quiet:
                break
        moved = st.core_ptr.cpu().numpy().astype(np.int64)
        pos += moved
        if src.exhausted(pos) and bool(quiescent(st)):
            break
        if not moved.any():
            break                      # no progress: budget exhausted
    ts_end = int(st.mem.cycle)
    for tid in list(open_spans):
        end(tid, ts_end)
    return events


def export_chrome_trace(events: List[dict], path: str,
                        manifest: Optional[dict] = None) -> str:
    """Write events as a Chrome-trace JSON file (Perfetto-loadable)."""
    from repro_torch.obs.runlog import run_manifest
    blob = {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"manifest": manifest or run_manifest(),
                          "time_unit": "1 us = 1 simulated cycle"}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(blob, f, default=float)
    return path


def timeline_of(pt, *, chunk_len: int, max_cycles: int,
                device=None) -> List[dict]:
    """``record_timeline`` of a ``SweepPoint``'s trace on its own system
    and tunables (the CLI's run), on ``device`` (the card unless named)."""
    from repro_torch.core.state import TunableParams
    from repro_torch.sweep.engine import stack_tunables, system_for
    from repro_torch.sweep.workloads import build_trace

    system = system_for(pt, device=device)
    tn = TunableParams(*(int(x[0]) for x in stack_tunables(
        [pt], system.p.queue_depth, "cpu")))
    return record_timeline(system, build_trace(pt, device=system.device),
                           chunk_len=chunk_len, tn=tn,
                           max_cycles=max_cycles)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scheme", default="scheme_i")
    ap.add_argument("--trace", default="banded",
                    help="trace generator (repro_torch.sim.trace.TRACES)")
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--r", type=float, default=0.05)
    ap.add_argument("--n-rows", type=int, default=128)
    ap.add_argument("--length", type=int, default=96)
    ap.add_argument("--chunk-len", type=int, default=32)
    ap.add_argument("--select-period", type=int, default=32)
    ap.add_argument("--max-cycles", type=int, default=4096)
    ap.add_argument("--out", default="experiments/torch/obs/timeline.json")
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny workload")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.length, args.n_rows, args.max_cycles = 32, 64, 512

    from repro_torch.obs.runlog import run_manifest
    from repro_torch.sweep.grid import SweepPoint
    pt = SweepPoint(scheme=args.scheme, trace=args.trace, alpha=args.alpha,
                    r=args.r, n_rows=args.n_rows, length=args.length,
                    select_period=args.select_period)
    events = timeline_of(pt, chunk_len=args.chunk_len,
                         max_cycles=args.max_cycles, device=args.device)
    path = export_chrome_trace(events, args.out,
                               manifest=run_manifest(config=pt))
    n_real = sum(1 for e in events if e["ph"] != "M")
    print(f"wrote {path}: {len(events)} events ({n_real} non-metadata) — "
          f"open in chrome://tracing or ui.perfetto.dev")
    return 0 if n_real > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
