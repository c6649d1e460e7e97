"""Fig 18 on the port: CPU cycles + dynamic-coding region switches vs α on
a dedup-like banded trace (r=0.05), schemes I–III vs the uncoded baseline;
the port of ``benchmarks/fig18_dedup.py``, with the same rows and table.

    python -m repro_torch.harness.fig18_dedup               # on the card
    python -m repro_torch.harness.fig18_dedup --device cpu

Runs through ``repro_torch.sweep`` (the ``paper_fig18`` suite,
``run_sweep``): ``partition`` batches the uncoded point alone, each
scheme's α < 1 points together (traced geometry) and its α = 1 point
alone, and each batch runs lock-step until every point is quiescent.
Beside the table it prints each batch's batched cycles against
``drain_bound`` and the grid's wall time with the device it ran on.

Paper validation targets (§V-C): a large cycle reduction once α is
sufficient; α=1.0 → zero region switches; α=0.05 (one slot) vacillates
between the two hot bands (many switches), α=0.1 (two slots) codes both.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.paper_memsys import PAPER_ALPHAS, PAPER_SCHEMES
from repro_torch.harness.common import emit, report_batches, run_grid, table
from repro_torch.kernels.common import resolve_device
from repro_torch.sweep import SweepPoint
from repro_torch.sweep.workloads import paper_fig18


def run(length: int = 96, n_rows: int = 320, r: float = 0.05,
        alphas=PAPER_ALPHAS, schemes=PAPER_SCHEMES, seed: int = 0,
        select_period: int = 32, device=None, on_cycle=None):
    """The Fig 18 table on ``device`` (the card unless the caller names
    another). ``on_cycle(batch, before, after, out)`` sees every batched
    cycle when given."""
    dev = resolve_device(device)
    base = SweepPoint(trace="banded", n_rows=n_rows, length=length,
                      n_cores=8, n_banks=8, seed=seed, write_frac=0.3,
                      select_period=select_period)
    pts = paper_fig18(base, schemes=schemes, alphas=alphas, r=r)
    rs, counter, secs = run_grid(pts, dev, on_cycle)
    rows = []
    for row in rs.rows():
        uncoded = row["scheme"] == "uncoded"
        rows.append({
            "scheme": row["scheme"], "alpha": None if uncoded else row["alpha"],
            "cycles": row["cycles"],
            "reduction_%": row.get("cycle_reduction_%", 0.0),
            "switches": 0 if uncoded else row["switches"],
            "degraded": row["degraded_reads"], "parked": row["parked_writes"],
            "read_lat": round(row["avg_read_latency"], 2),
        })
    print("\n== Fig 18: dedup-like banded trace, cycles & switches vs α ==")
    print(table(rows, list(rows[0].keys())))
    batches = report_batches(pts, counter, secs, dev)
    emit("fig18_dedup", rows, {"r": r, "length": length, "n_rows": n_rows,
                               "device": str(dev), "batches": batches},
         timings={"grid_s": secs})
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--length", type=int, default=96)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    run(length=args.length, device=args.device)
