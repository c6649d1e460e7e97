"""Stall-attribution and availability reports of a paper suite; the port of
``repro/obs/report.py``.

``stall_report`` runs a paper suite (fig18/19/20) with the telemetry
planes on, checks the planes against the ``SimResult`` aggregates (it
refuses to render numbers that disagree with the engine), and writes a
markdown report and its JSON twin into ``experiments/obs/``:

* a per-point table: stalls by cause, wait cycles by cause, the degraded
  share of reads and the parked share of writes;
* coded against uncoded for the suite's baseline pair;
* a per-bank heatmap of a coded exemplar (stalls, waits, queue high-water
  marks by bank);
* the exemplar's log2 critical-word read and write latency histograms.

``availability_report`` runs the suite with a fault plan on every point
and renders reads served against failed fast, lost writes, the
fault-degraded share and the per-bank dead cycles.

Both run on the card unless ``device`` names another. Not ported: the
serving report (``serve_report``, ``drive_serve_with_oracle``), which
needs a port-side copy of the JAX package's serving oracle.

CLI::

    PYTHONPATH=src python -m repro_torch.obs.report --suite paper_fig18 \\
        --smoke --device cpu
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
                 base=None, out_dir: str = "experiments/obs",
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
                        out_dir: str = "experiments/obs",
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--suite", default="paper_fig18",
                    choices=("paper_fig18", "paper_fig19", "paper_fig20"))
    ap.add_argument("--out-dir", default="experiments/obs")
    ap.add_argument("--smoke", action="store_true",
                    help="trimmed axes and a tiny trace")
    ap.add_argument("--availability", action="store_true",
                    help="the fault-availability report instead of stall "
                         "attribution")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    fn = availability_report if args.availability else stall_report
    out = fn(args.suite, out_dir=args.out_dir, smoke=args.smoke,
             device=args.device)
    n = len(out["points"])
    print(f"wrote {out['md_path']} and {out['json_path']} ({n} points, "
          f"planes == aggregates verified)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
