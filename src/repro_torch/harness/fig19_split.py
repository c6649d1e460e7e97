"""Fig 19 on the port: the split-band augmentation (many narrow bands);
the port of ``benchmarks/fig19_split.py``, with the same rows and table.
Paper claim: with many bands, matching the baseline-trace gains needs a
larger α (more coded regions) or a larger partition coefficient r.

    python -m repro_torch.harness.fig19_split               # on the card
    python -m repro_torch.harness.fig19_split --device cpu

Runs through ``repro_torch.sweep`` (the ``paper_fig19`` suite,
``run_sweep``): the uncoded point alone, scheme I's α < 1 points at the
three r together (traced geometry) and its α = 1 points together. Beside
the table it prints each batch's batched cycles against ``drain_bound``
and the grid's wall time with the device it ran on.
"""
from __future__ import annotations

import argparse

from repro_torch.harness.common import emit, report_batches, run_grid, table
from repro_torch.kernels.common import resolve_device
from repro_torch.sweep import SweepPoint
from repro_torch.sweep.workloads import paper_fig19


def run(length: int = 96, n_rows: int = 320, seed: int = 0, device=None,
        on_cycle=None):
    """The Fig 19 table on ``device`` (the card unless the caller names
    another). ``on_cycle(batch, before, after, out)`` sees every batched
    cycle when given."""
    dev = resolve_device(device)
    base = SweepPoint(n_rows=n_rows, length=length, n_cores=8, n_banks=8,
                      seed=seed, write_frac=0.3, select_period=64)
    pts = paper_fig19(base, rs=(0.05, 0.125, 0.25),
                      alphas=(0.1, 0.25, 0.5, 1.0))
    rs, counter, secs = run_grid(pts, dev, on_cycle)
    rows = []
    for row in rs.rows():
        uncoded = row["scheme"] == "uncoded"
        rows.append({
            "scheme": row["scheme"],
            "alpha": None if uncoded else row["alpha"],
            "r": None if uncoded else row["r"],
            "cycles": row["cycles"],
            "reduction_%": row.get("cycle_reduction_%", 0.0),
            "switches": 0 if uncoded else row["switches"],
        })
    print("\n== Fig 19: split-band trace — gains need larger α or r ==")
    print(table(rows, list(rows[0].keys())))
    batches = report_batches(pts, counter, secs, dev)
    emit("fig19_split", rows, {"length": length, "n_rows": n_rows,
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
