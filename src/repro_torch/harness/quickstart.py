"""Quickstart: the paper's coded memory system in miniature, on the port;
the counterpart of ``examples/quickstart.py``.

Builds a Scheme-I coded memory over 8 single-port banks, runs a dedup-like
multi-core trace through the controller, and compares against the uncoded
baseline — the in-miniature version of the paper's Fig 18 experiment.

    python -m repro_torch.harness.quickstart                # on the card
    python -m repro_torch.harness.quickstart --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.sim.ramulator import compare_schemes, cycle_reduction
from repro_torch.sim.trace import TraceSpec, banded_trace


def main(device=None):
    """Each scheme's ``SimResult`` on ``device`` (the card unless the
    caller names another); raises unless scheme I beats uncoded."""
    # 8 cores hammering 2 hot address bands (PARSEC dedup structure, Fig 15)
    spec = TraceSpec(n_cores=8, length=64, n_banks=8, n_rows=256,
                     write_frac=0.3, seed=0)
    trace = banded_trace(spec, device=device)

    results = compare_schemes(
        trace, n_rows=256, alpha=1.0, r=0.25, n_cycles=512,
        schemes=("uncoded", "scheme_i", "scheme_ii", "scheme_iii"),
        device=device,
    )
    base = results["uncoded"]
    print(f"{'scheme':12s} {'cycles':>7s} {'reduction':>10s} {'degraded':>9s} "
          f"{'parked':>7s} {'read lat':>9s}")
    for name, res in results.items():
        red = cycle_reduction(base, res)
        print(f"{name:12s} {res.cycles:7d} {100*red:9.1f}% "
              f"{res.degraded_reads:9d} {res.parked_writes:7d} "
              f"{res.avg_read_latency:9.2f}")
    if not results["scheme_i"].cycles < base.cycles:
        raise AssertionError("coding must win here")
    print("\ncoded memory served the same workload in fewer memory cycles —")
    print("idle banks + XOR parities acted as extra read/write ports.")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
