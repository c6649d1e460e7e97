"""Fig 20 on the port: the linear-ramp augmentation (drifting hot bands);
the port of ``benchmarks/fig20_ramp.py``, with the same rows and table.
Paper claim: the dynamic coding unit struggles to track a constantly
moving primary region, so gains shrink against the static-band case and
switch counts rise with drift.

    python -m repro_torch.harness.fig20_ramp                # on the card
    python -m repro_torch.harness.fig20_ramp --device cpu

Runs through ``repro_torch.sweep`` (the ``paper_fig20`` suite,
``run_sweep``): the three uncoded points batch together, and so do the
six scheme I points (α 0.1 and 0.25 at each drift; their region switches
run the ``xor_encode`` kernel). Beside the table it prints each batch's
batched cycles against ``drain_bound`` and the grid's wall time.
"""
from __future__ import annotations

import argparse

from repro_torch.harness.common import emit, report_batches, run_grid, table
from repro_torch.kernels.common import resolve_device
from repro_torch.sweep import SweepPoint
from repro_torch.sweep.workloads import drift_label, paper_fig20

_NAMES = {0.0: "static", 0.25: "ramp_slow", 1.0: "ramp_fast"}


def run(length: int = 96, n_rows: int = 320, seed: int = 0, device=None,
        on_cycle=None):
    """The Fig 20 table on ``device`` (the card unless the caller names
    another). ``on_cycle(batch, before, after, out)`` sees every batched
    cycle when given."""
    dev = resolve_device(device)
    base = SweepPoint(n_rows=n_rows, length=length, n_cores=8, n_banks=8,
                      seed=seed, write_frac=0.3, select_period=64, r=0.05)
    drifts = (0.0, 0.25, 1.0)
    pts = paper_fig20(base, drifts=drifts, alphas=(0.1, 0.25))
    rs, counter, secs = run_grid(pts, dev, on_cycle)
    rows = []
    for drift in drifts:
        label = drift_label(drift)
        uncoded = rs.one(scheme="uncoded", label=label).result
        for rec in rs.by(scheme="scheme_i", label=label):
            rows.append({
                "trace": _NAMES[drift], "alpha": rec.point.alpha,
                "uncoded_cycles": uncoded.cycles,
                "coded_cycles": rec.result.cycles,
                "reduction_%": round(
                    100 * (1 - rec.result.cycles / uncoded.cycles), 1),
                "switches": rec.result.switches,
            })
    print("\n== Fig 20: ramp trace — drifting bands defeat dynamic coding ==")
    print(table(rows, list(rows[0].keys())))
    batches = report_batches(pts, counter, secs, dev)
    emit("fig20_ramp", rows, {"length": length, "n_rows": n_rows,
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
