"""Stall-attribution and availability reports of a paper suite; the port of
``repro/obs/report.py``.

``stall_report`` runs a paper suite (fig18/19/20) with the telemetry
planes on, checks the planes against the ``SimResult`` aggregates (it
refuses to render numbers that disagree with the engine), and writes a
markdown report and its JSON twin into ``experiments/torch/obs/``:

* a per-point table: stalls by cause, wait cycles by cause, the degraded
  share of reads and the parked share of writes;
* coded against uncoded for the suite's baseline pair;
* a per-bank heatmap of a coded exemplar (stalls, waits, queue high-water
  marks by bank);
* the exemplar's log2 critical-word read and write latency histograms.

``availability_report`` runs the suite with a fault plan on every point
and renders reads served against failed fast, lost writes, the
fault-degraded share and the per-bank dead cycles.

``serve_report`` serves a small continuous-batching workload over the
coded KV pool with the serve planes on (``drive_serve_with_oracle``
replays every decode step in the NumPy oracle ``repro_torch.oracle.
kvpool``), holds the planes against the replay exactly, and writes the
request-path report, its JSON twin and a Chrome trace of the request
spans.

All three run on the card unless ``device`` names another.

CLI::

    PYTHONPATH=src python -m repro_torch.obs.report --suite paper_fig18 \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.obs.report --serve --smoke \\
        --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np

from repro_torch.obs import planes

# trimmed suite axes for --smoke: one coded scheme, one alpha
_SMOKE_KW = {
    "paper_fig18": dict(schemes=("scheme_i",), alphas=(0.25,)),
    "paper_fig19": dict(rs=(0.05,), alphas=(0.25,)),
    "paper_fig20": dict(drifts=(0.0, 1.0), alphas=(0.25,)),
}


def _bar(v: int, vmax: int, width: int = 10) -> str:
    if vmax <= 0:
        return ""
    return "#" * max(int(round(width * v / vmax)), 1 if v else 0)


def _pct(num: int, den: int) -> str:
    return f"{100.0 * num / den:.1f}%" if den else "-"


def _md_table(headers: List[str], rows: List[List[str]]) -> List[str]:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    out += ["| " + " | ".join(str(c) for c in row) + " |" for row in rows]
    return out


def _check_against_result(pt, res, snap) -> None:
    """The planes must sum exactly to the engine's own aggregates."""
    pairs = [
        ("stall_cycles", snap.stall_total(), res.stall_cycles),
        ("served_reads", snap.served_reads(), res.served_reads),
        ("served_writes", snap.served_writes(), res.served_writes),
        ("degraded_reads", snap.degraded_reads(), res.degraded_reads),
        ("parked_writes", snap.parked_writes(), res.parked_writes),
        ("fault_degraded_reads", snap.fault_degraded_reads(),
         res.fault_degraded_reads),
        ("dead_bank_cycles", snap.dead_bank_cycles(), res.dead_bank_cycles),
    ]
    for name, plane, agg in pairs:
        if int(plane) != int(agg):
            raise AssertionError(
                f"telemetry plane disagrees with SimResult on {name} for "
                f"{pt.scheme} alpha={pt.alpha} r={pt.r}: plane sum "
                f"{int(plane)} != aggregate {int(agg)}")


def _point_row(pt, res, snap) -> List[str]:
    st = snap.stall_by_cause()
    wt = snap.wait_by_cause()
    return [
        pt.scheme, f"{pt.alpha:g}", f"{pt.r:g}", str(res.cycles),
        str(res.served_reads), str(res.served_writes),
        str(snap.stall_total()),
        str(st["read_queue_full"]), str(st["write_queue_full"]),
        str(wt["read_conflict"]), str(wt["write_conflict"]),
        str(wt["recode_pending"]),
        _pct(snap.degraded_reads(), res.served_reads),
        _pct(snap.parked_writes(), res.served_writes),
    ]


def _bank_heatmap(snap) -> List[str]:
    rows = []
    hw = np.maximum(snap.rq_hwm, 0)
    for b in range(snap.stall_cause.shape[0]):
        rows.append([
            str(b),
            str(int(snap.stall_cause[b, 0])), str(int(snap.stall_cause[b, 1])),
            str(int(snap.wait_cause[b, 0])), str(int(snap.wait_cause[b, 1])),
            str(int(snap.wait_cause[b, 2])),
            str(int(hw[b])), str(int(max(snap.wq_hwm[b], 0))),
            _bar(int(snap.wait_cause[b].sum()),
                 int(max(snap.wait_cause.sum(axis=1).max(), 1))),
        ])
    return _md_table(
        ["bank", "stall:rq_full", "stall:wq_full", "wait:read", "wait:write",
         "wait:recode", "rq hwm", "wq hwm", "wait load"], rows)


def _latency_rows(snap) -> List[tuple]:
    """The non-empty bins of a snapshot's latency histograms: (bin, span
    of latencies in cycles, reads, writes)."""
    out = []
    for k in range(planes.HIST_BINS):
        r, w = int(snap.lat_hist_read[k]), int(snap.lat_hist_write[k])
        if r == 0 and w == 0:
            continue
        lo = 0 if k == 0 else 1 << (k - 1)
        hi = "inf" if k == planes.HIST_BINS - 1 else (1 << k) - 1
        span = str(lo) if hi != "inf" and lo == int(hi) else f"{lo}-{hi}"
        out.append((k, span, r, w))
    return out


def _latency_section(snap) -> List[str]:
    lines = ["| bin | latency | reads | writes | |", "|---|---|---|---|---|"]
    vmax = int(max(snap.lat_hist_read.max(), snap.lat_hist_write.max(), 1))
    for k, span, r, w in _latency_rows(snap):
        lines.append(f"| {k} | {span} | {r} | {w} | "
                     f"{_bar(r + w, 2 * vmax)} |")
    return lines


def suite_points(suite_name: str = "paper_fig18", *, base=None,
                 smoke: bool = False, **suite_kw) -> list:
    """The points a report runs (before it turns telemetry on): the suite
    on ``base`` (default 96 requests a core on 128 rows; with ``smoke``
    32 on 64 and the trimmed axes)."""
    from repro_torch.sweep.grid import SweepPoint
    from repro_torch.sweep.workloads import suite

    if base is None:
        base = SweepPoint(length=32, n_rows=64) if smoke else \
            SweepPoint(length=96, n_rows=128)
    kw = dict(_SMOKE_KW.get(suite_name, {})) if smoke else {}
    kw.update(suite_kw)
    return suite(suite_name, base, **kw)


def _run_suite(suite_name, base, smoke, suite_kw, device, on_cycle,
               **replace):
    """The suite's points (telemetry on, ``replace`` applied), their
    results and snapshots, each snapshot checked against its result."""
    from repro_torch.sweep.engine import run_points
    from repro_torch.sweep.workloads import build_trace

    pts = [pt.replace(telemetry=True, **replace) for pt in suite_points(
        suite_name, base=base, smoke=smoke, **suite_kw)]
    traces = [build_trace(pt, index=i, device=device)
              for i, pt in enumerate(pts)]
    results, snaps = run_points(pts, traces=traces, collect_telemetry=True,
                                device=device, on_cycle=on_cycle)
    for pt, res, snap in zip(pts, results, snaps):
        if snap is None:
            raise AssertionError(f"telemetry-on point returned no snapshot: "
                                 f"{pt.scheme} alpha={pt.alpha}")
        _check_against_result(pt, res, snap)
    return pts, results, snaps


def _header(title, manifest, n_points, smoke, extra="") -> List[str]:
    return [title, "",
            f"git `{manifest['git_sha'][:12]}` · "
            f"{manifest['created_iso']} · "
            f"{manifest['devices']['backend']} backend · "
            f"{n_points} points" + extra + (" · smoke" if smoke else ""), ""]


def _write(out_dir, stem, lines, blob):
    os.makedirs(out_dir, exist_ok=True)
    md_path = os.path.join(out_dir, f"{stem}.md")
    with open(md_path, "w") as f:
        f.write("\n".join(lines))
    json_path = os.path.join(out_dir, f"{stem}.json")
    with open(json_path, "w") as f:
        json.dump(blob, f, default=float)
    return md_path, json_path


def stall_report(suite_name: str = "paper_fig18", *,
                 base=None, out_dir: str = "experiments/torch/obs",
                 smoke: bool = False, device=None, on_cycle=None,
                 **suite_kw) -> Dict:
    """Run ``suite_name`` with telemetry on and write the attribution
    report (``on_cycle`` is ``run_points``'). Returns ``{"md_path", "json_path", "points", "results",
    "snapshots", "exemplar", "uncoded"}`` (the last two: the indices of
    the coded exemplar and of the uncoded anchor, or None)."""
    from repro_torch.obs.runlog import run_manifest

    pts, results, snaps = _run_suite(suite_name, base, smoke, suite_kw,
                                     device, on_cycle)
    manifest = run_manifest(config={"suite": suite_name, "smoke": smoke,
                                    "n_points": len(pts)})
    # the exemplar: the busiest coded point (most wait cycles) gets the
    # per-bank and latency sections; uncoded is the comparison anchor
    coded = [i for i, pt in enumerate(pts) if pt.scheme != "uncoded"]
    uncoded = [i for i, pt in enumerate(pts) if pt.scheme == "uncoded"]
    ex = max(coded, key=lambda i: int(snaps[i].wait_cause.sum())) \
        if coded else 0

    lines = _header(f"# Stall attribution — {suite_name}", manifest,
                    len(pts), smoke)
    lines += ["Planes cross-checked against `SimResult` aggregates "
              "(stalls, served, degraded, parked) — exact equality "
              "asserted before rendering.", "", "## Per-point summary", ""]
    lines += _md_table(
        ["scheme", "alpha", "r", "cycles", "reads", "writes", "stalls",
         "rq full", "wq full", "wait rd", "wait wr", "wait rc",
         "degraded", "parked"],
        [_point_row(pt, res, snap)
         for pt, res, snap in zip(pts, results, snaps)])

    if coded and uncoded:
        u, c = uncoded[0], ex
        ur, cr = results[u], results[c]
        lines += ["", "## Coded vs uncoded", "",
                  f"Exemplar: `{pts[c].scheme}` alpha={pts[c].alpha:g} "
                  f"r={pts[c].r:g} vs `uncoded`.", ""]
        lines += _md_table(
            ["metric", "uncoded", pts[c].scheme],
            [["cycles", str(ur.cycles), str(cr.cycles)],
             ["stall cycles", str(ur.stall_cycles), str(cr.stall_cycles)],
             ["wait cycles (all causes)",
              str(int(snaps[u].wait_cause.sum())),
              str(int(snaps[c].wait_cause.sum()))],
             ["degraded reads", _pct(snaps[u].degraded_reads(),
                                     ur.served_reads),
              _pct(snaps[c].degraded_reads(), cr.served_reads)],
             ["parked writes", _pct(snaps[u].parked_writes(),
                                    ur.served_writes),
              _pct(snaps[c].parked_writes(), cr.served_writes)]])

    expt = pts[ex]
    lines += ["", f"## Per-bank heatmap — `{expt.scheme}` "
              f"alpha={expt.alpha:g} r={expt.r:g}", ""]
    lines += _bank_heatmap(snaps[ex])
    lines += ["", "## Latency histograms (log2 bins, cycles) — exemplar", ""]
    lines += _latency_section(snaps[ex])
    lines.append("")

    blob = {"suite": suite_name, "manifest": manifest,
            "points": [{"scheme": pt.scheme, "alpha": pt.alpha, "r": pt.r,
                        "seed": pt.seed, "label": pt.label,
                        "cycles": int(res.cycles),
                        "stall_cycles": int(res.stall_cycles),
                        "telemetry": snap.as_dict()}
                       for pt, res, snap in zip(pts, results, snaps)]}
    md_path, json_path = _write(out_dir, f"stall_report_{suite_name}",
                                lines, blob)
    return {"md_path": md_path, "json_path": json_path, "points": pts,
            "results": results, "snapshots": snaps, "exemplar": ex,
            "uncoded": uncoded[0] if uncoded else None}


def availability_report(suite_name: str = "paper_fig18", *,
                        faults=(("bank", 0, 0),), base=None,
                        out_dir: str = "experiments/torch/obs",
                        smoke: bool = False, device=None, on_cycle=None,
                        **suite_kw) -> Dict:
    """Run ``suite_name`` with the fault plan ``faults`` on every point
    (default: data bank 0 dead from cycle 0) and telemetry on, and render
    the availability view; the planes are checked against the aggregates
    as in ``stall_report``. Returns ``{"md_path", "json_path", "points",
    "results", "snapshots"}``."""
    from repro_torch.obs.runlog import run_manifest

    pts, results, snaps = _run_suite(suite_name, base, smoke, suite_kw,
                                     device, on_cycle, faults=tuple(faults))
    manifest = run_manifest(config={"suite": suite_name, "smoke": smoke,
                                    "faults": list(map(list, faults)),
                                    "n_points": len(pts)})
    lines = _header(f"# Fault availability — {suite_name}", manifest,
                    len(pts), smoke, f" · fault plan `{tuple(faults)}`")
    lines += ["A read is *unserved* when the fail-fast drop found no "
              "serving option under the failures; a write is *lost* when "
              "its bank is down with no parity coverage to park into. "
              "*Fault-degraded* reads were served through parity because "
              "their bank was down — availability the coding bought.", "",
              "## Per-point availability", ""]
    rows = []
    for pt, res, snap in zip(pts, results, snaps):
        issued_r = res.served_reads + res.unserved_reads
        rows.append([
            pt.scheme, f"{pt.alpha:g}", f"{pt.r:g}", str(res.cycles),
            _pct(res.served_reads, issued_r), str(res.unserved_reads),
            str(res.lost_writes),
            _pct(snap.fault_degraded_reads(), res.served_reads),
            str(res.dead_bank_cycles),
        ])
    lines += _md_table(
        ["scheme", "alpha", "r", "cycles", "reads served", "unserved",
         "lost wr", "fault-degraded", "dead cycles"], rows)

    # per-bank dead cycles of the point with the most
    ex = max(range(len(pts)),
             key=lambda i: int(snaps[i].dead_cycles.sum()))
    expt, snap = pts[ex], snaps[ex]
    lines += ["", f"## Per-bank dead cycles — `{expt.scheme}` "
              f"alpha={expt.alpha:g} r={expt.r:g}", ""]
    vmax = int(max(snap.dead_cycles.max(), 1))
    lines += _md_table(
        ["bank", "dead cycles", ""],
        [[str(b), str(int(snap.dead_cycles[b])),
          _bar(int(snap.dead_cycles[b]), vmax)]
         for b in range(snap.dead_cycles.shape[0])])
    lines.append("")

    blob = {"suite": suite_name, "manifest": manifest,
            "points": [{"scheme": pt.scheme, "alpha": pt.alpha, "r": pt.r,
                        "seed": pt.seed, "label": pt.label,
                        "cycles": int(res.cycles),
                        "unserved_reads": int(res.unserved_reads),
                        "lost_writes": int(res.lost_writes),
                        "fault_degraded_reads": int(res.fault_degraded_reads),
                        "dead_bank_cycles": int(res.dead_bank_cycles),
                        "telemetry": snap.as_dict()}
                       for pt, res, snap in zip(pts, results, snaps)]}
    md_path, json_path = _write(out_dir, f"availability_{suite_name}",
                                lines, blob)
    return {"md_path": md_path, "json_path": json_path, "points": pts,
            "results": results, "snapshots": snaps}


def drive_serve_with_oracle(srv, reqs, max_steps: int = 1000,
                            churn_every: int = 0, churn_rng=None):
    """Drive a pooled server to drain while replaying every decode step in
    the ``repro_torch.oracle.kvpool`` golden model. Returns the
    accumulated ``PlaneTotals``; raises AssertionError when the device's
    code-status table leaves the oracle's replay after a step.
    ``churn_every`` applies a seeded physical-page permutation every k
    steps (placement churn, where degraded reads pay off)."""
    from repro_torch.oracle import kvpool

    def host(t):
        return t.detach().cpu().numpy()

    totals = kvpool.plane_totals(srv.kvcfg.n_banks)
    for r in reqs:
        srv.submit(r)
    for step in range(max_steps):
        srv._admit()
        if churn_every and step and step % churn_every == 0:
            srv.permute_pool(churn_rng.permutation(srv.kvcfg.pool_pages))
        if not any(s is not None for s in srv.slots):
            break
        pool = srv.cache["pool"]
        pt, length = host(pool.page_table), host(pool.length)
        fresh = host(pool.parity_fresh) if pool.parity_fresh.shape[0] \
            else None
        active = (pt[:, 0] >= 0) & (length > 0)
        exp = kvpool.expected_step(srv.kvcfg.n_banks, srv.kvcfg.page, pt,
                                   length, fresh, active,
                                   srv.sc.recode_budget)
        totals.add(exp)
        srv.step_decode()
        if fresh is not None and not np.array_equal(
                host(srv.cache["pool"].parity_fresh),
                exp.parity_fresh_after):
            raise AssertionError(
                "code-status table diverged from the oracle replay")
    return totals


def _serve_lifecycle_table(spans) -> List[str]:
    def ms(x):
        return f"{1e3 * x:.1f}" if x is not None else "-"

    rows = []
    for s in spans:
        itl = s["inter_token_s"]
        rows.append([
            str(s["rid"]), str(s["slot"]), str(s["prompt_len"]),
            ms(s["admission_wait_s"]), ms(s["ttft_s"]), str(s["n_tokens"]),
            ms(float(np.mean(itl)) if itl else None),
        ])
    return _md_table(
        ["req", "slot", "prompt", "wait ms", "ttft ms", "tokens",
         "mean itl ms"], rows)


def serve_setup(*, smoke: bool = False, seed: int = 0, device=None):
    """The report's server and requests: reduced qwen2.5-3b with page 4
    on the coded pool (4 slots, prompts of 6..13 tokens cut to 16,
    max_seq 64), 5 requests of 6 tokens (``smoke``) or 10 of 16, the
    serve planes on, params drawn from ``seed`` on ``device``."""
    import dataclasses as _dc

    from repro_torch.configs.base import get_config
    from repro_torch.models import lm as lm_mod
    from repro_torch.runtime.server import Request, ServeConfig, Server

    cfg = _dc.replace(get_config("qwen2.5-3b").reduced(), kv_page=4)
    n_req = 5 if smoke else 10
    sc = ServeConfig(n_slots=4, max_prompt=16, max_seq=64,
                     max_new_tokens=6 if smoke else 16, telemetry=True)
    params = lm_mod.init_params(cfg, seed=seed, device=device)
    srv = Server(cfg, sc, params, device=device)
    if not srv.pooled:
        raise AssertionError("serve_report needs the coded KV pool backend")
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i,
                    prompt=[int(x) for x in
                            rng.integers(1, cfg.vocab, size=6 + i % 8)])
            for i in range(n_req)]
    return srv, reqs


def serve_report(*, out_dir: str = "experiments/torch/obs",
                 smoke: bool = False, seed: int = 0, device=None) -> Dict:
    """Serve ``serve_setup``'s workload with a placement churn every 2
    steps, hold every plane against the ``repro_torch.oracle.kvpool``
    replay (exact equality: the report refuses to render numbers that
    disagree), and write the request-path report: markdown, its JSON twin
    and a Chrome trace of the request lifecycle spans. The planes depend
    on the requests' lengths and the placement only, not on the weights.
    Returns ``{"md_path", "json_path", "trace_path", "snapshot",
    "totals", "spans", "summary"}``."""
    from repro_torch.obs.runlog import run_manifest

    srv, reqs = serve_setup(smoke=smoke, seed=seed, device=device)
    sc, n_req = srv.sc, len(reqs)
    totals = drive_serve_with_oracle(srv, reqs, churn_every=2,
                                     churn_rng=np.random.default_rng(seed))
    snap = srv.serve_snapshot()
    if snap is None:
        raise AssertionError("serve_report: the serve planes are off")
    snap.check_against(totals)          # exact equality or AssertionError
    spans = srv.log.spans()
    summary = srv.log.summary()

    manifest = run_manifest(config={
        "model": srv.cfg.name, "smoke": smoke, "n_requests": n_req,
        "n_slots": sc.n_slots, "page": srv.kvcfg.page,
        "n_banks": srv.kvcfg.n_banks, "pool_pages": srv.kvcfg.pool_pages})
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "serve_trace.json")
    srv.log.export_chrome_trace(trace_path, manifest=manifest)

    lines = ["# Serving request path — coded KV pool", "",
             f"git `{manifest['git_sha'][:12]}` · "
             f"{manifest['created_iso']} · "
             f"{manifest['devices']['backend']} backend · "
             f"{n_req} requests, {sc.n_slots} slots, "
             f"{srv.kvcfg.n_banks} banks, page {srv.kvcfg.page}"
             + (" · smoke" if smoke else ""), "",
             "Device planes cross-checked against the pure-NumPy "
             "`repro_torch.oracle.kvpool` recompute — exact equality "
             "asserted before rendering.", "", "## Serving planes", ""]
    lines += _md_table(["metric", "value"], [
        ["decode steps", str(snap.decode_steps)],
        ["tokens appended", str(snap.appended_tokens)],
        ["page reads", str(snap.served_pages)],
        ["degraded reads", f"{snap.degraded_reads} "
         f"({_pct(snap.degraded_reads, snap.served_pages)})"],
        ["port cycles coded / uncoded",
         f"{snap.coded_cycles} / {snap.uncoded_cycles} "
         f"(saved {snap.cycles_saved})"],
        ["recoded rows", str(snap.recoded_rows)],
        ["stale backlog integral / high-water",
         f"{snap.stale_backlog} / {snap.stale_hwm}"],
    ])
    lines += ["", "## Per-bank read provenance", ""]
    vmax = int(max(snap.read_mode_bank.sum(axis=1).max(), 1))
    lines += _md_table(
        ["bank", "direct", "degraded", "load"],
        [[str(b), str(int(snap.read_mode_bank[b, 0])),
          str(int(snap.read_mode_bank[b, 1])),
          _bar(int(snap.read_mode_bank[b].sum()), vmax)]
         for b in range(snap.read_mode_bank.shape[0])])
    lines += ["", "## Critical-word latency (log2 bins, port cycles)", ""]
    agg = snap.port_lat_hist.sum(axis=0)
    hmax = int(max(agg.max(), 1))
    lines += ["| bin | latency | reads | |", "|---|---|---|---|"]
    for k in range(planes.HIST_BINS):
        if int(agg[k]) == 0:
            continue
        lo = 0 if k == 0 else 1 << (k - 1)
        hi = "inf" if k == planes.HIST_BINS - 1 else (1 << k) - 1
        span = str(lo) if hi != "inf" and lo == int(hi) else f"{lo}-{hi}"
        lines.append(f"| {k} | {span} | {int(agg[k])} | "
                     f"{_bar(int(agg[k]), hmax)} |")
    lines += ["", "## Request lifecycle", ""]
    lines += _serve_lifecycle_table(spans)
    ttft = summary["ttft_p50_s"]
    lines += ["", f"TTFT p50 {1e3 * ttft:.1f} ms · "
              f"admission wait p50 "
              f"{1e3 * (summary['admission_wait_p50_s'] or 0):.1f} ms · "
              f"spans exported to `{trace_path}`"
              if ttft is not None else "", ""]

    blob = {"manifest": manifest, "planes": snap.as_dict(),
            "lifecycle": {"summary": summary, "spans": spans},
            "trace_path": trace_path}
    md_path, json_path = _write(out_dir, "serve_report", lines, blob)
    return {"md_path": md_path, "json_path": json_path,
            "trace_path": trace_path, "snapshot": snap, "totals": totals,
            "spans": spans, "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--suite", default="paper_fig18",
                    choices=("paper_fig18", "paper_fig19", "paper_fig20"))
    ap.add_argument("--out-dir", default="experiments/torch/obs")
    ap.add_argument("--smoke", action="store_true",
                    help="trimmed axes and a tiny trace")
    ap.add_argument("--availability", action="store_true",
                    help="the fault-availability report instead of stall "
                         "attribution")
    ap.add_argument("--serve", action="store_true",
                    help="the request-path report of the coded KV serving "
                         "stack (obs.serve) instead of a sim suite")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.serve:
        out = serve_report(out_dir=args.out_dir, smoke=args.smoke,
                           device=args.device)
        print(f"wrote {out['md_path']}, {out['json_path']} and "
              f"{out['trace_path']} ({len(out['spans'])} requests, "
              "planes == oracle verified)")
        return 0
    fn = availability_report if args.availability else stall_report
    out = fn(args.suite, out_dir=args.out_dir, smoke=args.smoke,
             device=args.device)
    n = len(out["points"])
    print(f"wrote {out['md_path']} and {out['json_path']} ({n} points, "
          f"planes == aggregates verified)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
