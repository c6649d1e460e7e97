"""Degraded-availability gate on the port: erasure-coded serving under
dead banks; the port of ``benchmarks/fig_faults.py``, with the same rows,
table and gate.

    python -m repro_torch.harness.fig_faults                # on the card
    python -m repro_torch.harness.fig_faults --device cpu --smoke

Runs fig18/19/20-shaped workloads (banded, split-band and drifting-ramp
traces) at full coverage (α = 1, r = 0.25) with one data bank erased from
cycle 0 in every parity group:

  * scheme_i and scheme_iii must serve 100% of reads (no unserved read,
    no lost write): every request to a dead bank goes through a parity
    option or parks into parity, and the dead bank shows only as
    ``fault_degraded_reads`` and ``dead_bank_cycles``;
  * uncoded has no redundancy: the dead bank's requests are fail-fast
    dropped, the row that shows what the coding buys.

Full coverage matters: a dynamically coded point (α < 1) rightly drops
reads of a bank that dies before its regions are coded. The gate is
enforced: a coded row with unserved reads or lost writes, or an uncoded
row without unserved reads, exits nonzero. ``--smoke`` shrinks the
geometry (64 rows, 48 requests a core). At the default geometry (128 rows,
96 requests a core) a few reads of a dead bank in the coded rows are
dropped as well (their covering parity had gone stale from a direct write
to a live sibling), in the JAX package exactly as here, so the gate fails
there; ``availability`` gives the rows and the gate's messages without
the exit.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.harness.common import emit, report_batches, run_grid, table
from repro_torch.kernels.common import resolve_device
from repro_torch.sweep import SweepPoint

CODED = ("scheme_i", "scheme_iii")
ALPHA, R = 1.0, 0.25           # full coverage: every region pre-coded


def dead_banks(scheme: str) -> tuple:
    """One dead data bank per parity group (union-find over shared
    parities); the uncoded contrast kills bank 0."""
    from repro_torch.core.codes import get_tables

    t = get_tables(scheme)
    if not t.scheme.members:
        return (0,)
    parent = list(range(t.n_data))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for ms in t.scheme.members:
        for m in ms[1:]:
            parent[find(m)] = find(ms[0])
    return tuple(sorted({find(b) for b in range(t.n_data)}))


def _suite_points(suite: str, scheme: str, *, n_rows: int, length: int,
                  seed: int) -> list:
    from repro_torch.core.codes import get_tables
    from repro_torch.sweep.workloads import drift_label

    nd = get_tables(scheme).n_data
    spec = tuple(("bank", b, 0) for b in dead_banks(scheme))
    base = SweepPoint(scheme=scheme, alpha=ALPHA, r=R, n_rows=n_rows,
                      n_cores=8, n_banks=nd, n_data=nd, length=length,
                      seed=seed, write_frac=0.3, select_period=32,
                      faults=spec, suite=f"fig_faults/{suite}")
    if suite == "fig18":            # dedup-like banded trace
        return [base.replace(trace="banded")]
    if suite == "fig19":            # split-band augmentation
        return [base.replace(trace="split",
                             trace_kwargs=(("n_bands", 8),))]
    if suite == "fig20":            # drifting-ramp bands
        drift = 0.25
        return [base.replace(trace="ramp", label=drift_label(drift),
                             trace_kwargs=(("drift_total",
                                            nd * n_rows * drift),))]
    raise ValueError(suite)


def points(n_rows: int = 128, length: int = 96, seed: int = 0) -> list:
    """The gate's nine points: three suites × (scheme_i, scheme_iii,
    uncoded), each with its dead banks."""
    pts = []
    for suite in ("fig18", "fig19", "fig20"):
        for scheme in CODED + ("uncoded",):
            pts += _suite_points(suite, scheme, n_rows=n_rows,
                                 length=length, seed=seed)
    return pts


def availability(n_rows: int = 128, length: int = 96, seed: int = 0,
                 device=None, on_cycle=None):
    """The gate's rows on ``device`` (the card unless the caller names
    another), its table and batches printed, without the gate's exit:
    ``(rows, violations, meta)``, ``violations`` the gate's messages
    (empty when it holds) and ``meta`` the batches and the grid's wall
    seconds. ``on_cycle(batch, before, after, out)`` sees every batched
    cycle when given."""
    dev = resolve_device(device)
    pts = points(n_rows, length, seed)
    rs, counter, secs = run_grid(pts, dev, on_cycle)
    rows, violations = [], []
    for rec in rs:
        pt, res = rec.point, rec.result
        reads = res.served_reads + res.unserved_reads
        avail = 100.0 * res.served_reads / max(reads, 1)
        rows.append({
            "suite": pt.suite.split("/")[1], "scheme": pt.scheme,
            "dead_banks": ",".join(str(b) for b in dead_banks(pt.scheme)),
            "reads_served": res.served_reads,
            "unserved": res.unserved_reads,
            "lost_writes": res.lost_writes,
            "degraded_fault": res.fault_degraded_reads,
            "dead_cycles": res.dead_bank_cycles,
            "availability_%": round(avail, 2),
        })
        if pt.scheme in CODED and (res.unserved_reads or res.lost_writes):
            violations.append(
                f"{pt.suite} {pt.scheme}: {res.unserved_reads} unserved / "
                f"{res.lost_writes} lost writes (must be 0)")
        if pt.scheme == "uncoded" and res.unserved_reads == 0:
            violations.append(
                f"{pt.suite} uncoded: 0 unserved reads with a dead bank — "
                "the contrast row lost its contrast")
    print("\n== Fault gate: availability with dead banks "
          f"(α={ALPHA}, r={R}) ==")
    print(table(rows, list(rows[0].keys())))
    batches = report_batches(pts, counter, secs, dev)
    return rows, violations, {"device": str(dev), "batches": batches,
                              "grid_s": secs}


def run(n_rows: int = 128, length: int = 96, seed: int = 0,
        smoke: bool = False, device=None, on_cycle=None):
    """The availability table on ``device`` (the card unless the caller
    names another); exits 1 when the gate fails.
    ``on_cycle(batch, before, after, out)`` sees every batched cycle when
    given."""
    if smoke:
        n_rows, length = 64, 48
    rows, violations, meta = availability(n_rows, length, seed, device,
                                          on_cycle)
    emit("fig_faults", rows, {"alpha": ALPHA, "r": R, "n_rows": n_rows,
                              "length": length, "smoke": smoke,
                              "device": meta["device"],
                              "batches": meta["batches"]},
         timings={"grid_s": meta["grid_s"]})
    if violations:
        print("\nAVAILABILITY GATE FAILED:")
        for v in violations:
            print(f"  - {v}")
        sys.exit(1)
    print("\navailability gate OK: coded schemes served every read; "
          "uncoded did not")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-rows", type=int, default=128)
    ap.add_argument("--length", type=int, default=96)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    run(n_rows=args.n_rows, length=args.length, smoke=args.smoke,
        device=args.device)
