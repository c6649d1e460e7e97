"""The §III-B scheme-comparison table on the port: rate, storage overhead,
locality, best-case reads per cycle, measured from the code tables and the
read-pattern builder, plus end-to-end cycles on a shared uniform
worst-case trace through the batched sweep engine; the port of
``benchmarks/tab_schemes.py``, with the same rows and table.

    python -m repro_torch.harness.tab_schemes               # on the card
    python -m repro_torch.harness.tab_schemes --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import controller as ctl
from repro_torch.core.codes import get_tables
from repro_torch.core.state import make_params
from repro_torch.harness.common import emit, table, where
from repro_torch.kernels.common import resolve_device
from repro_torch.sweep import SweepPoint, run_points

SCHEMES = ("uncoded", "replication_2", "replication_4",
           "scheme_i", "scheme_ii", "scheme_iii")


def _n_data(name: str) -> int:
    return 9 if name == "scheme_iii" else 8


def _measure_best_case(name: str, device) -> int:
    """Serve the paper's §III-B best-case request mix through the read
    builder (a batch of one) on ``device``; reads served in one cycle."""
    t = get_tables(name, n_data=_n_data(name))
    p = make_params(t, n_rows=64, alpha=1.0, r=0.25)
    jt = ctl.jtables(t, device)
    if name == "scheme_iii":
        banks = [0, 0, 0, 0, 1, 2, 3, 4, 5]
        rows = [1, 2, 3, 4, 1, 2, 3, 4, 1]
    else:
        banks = [0, 1, 2, 3, 0, 1, 2, 3, 2, 3, 0, 1]
        rows = [1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 4, 4]
    n = len(banks)
    i32 = dict(dtype=torch.int32, device=device)
    plan = ctl.build_read_pattern(
        p, jt, torch.tensor(banks, **i32), torch.tensor(rows, **i32),
        torch.arange(n, **i32),
        torch.ones((n,), dtype=torch.bool, device=device),
        torch.zeros((p.n_ports + 1,), dtype=torch.bool, device=device),
        torch.zeros((p.n_data, p.n_rows), **i32),
        torch.ones((p.n_parities, p.n_slots * p.region_size),
                   dtype=torch.bool, device=device),
        torch.arange(p.n_regions, **i32))
    return int(plan.n_served)


def run(alpha: float = 0.25, device=None, on_cycle=None):
    """The scheme table on ``device`` (the card unless the caller names
    another). ``on_cycle(batch, before, after, out)`` sees every batched
    cycle of the uniform-trace runs when given."""
    dev = resolve_device(device)
    # end-to-end worst-case column: every scheme on the same uniform
    # trace, one batch per static shape (n_data differs for III)
    pts = [SweepPoint(scheme=name, n_data=_n_data(name), n_rows=64,
                      alpha=1.0, r=0.25, trace="uniform", n_cores=4,
                      length=32, seed=0)
           for name in SCHEMES]
    uniform_cycles = {name: res.cycles for name, res in
                      zip(SCHEMES, run_points(pts, device=dev,
                                              on_cycle=on_cycle))}
    rows = []
    for name in SCHEMES:
        t = get_tables(name, n_data=_n_data(name))
        s = t.scheme
        rows.append({
            "scheme": name,
            "data_banks": s.n_data,
            "parity_banks(phys)": s.n_phys,
            "rate(α=1)": round(s.rate(1.0), 4),
            f"rate(α={alpha})": round(s.rate(alpha), 4),
            "locality": s.locality(),
            "reads/bank": int(t.opt_n.min()) + 1 if s.n_parities else 1,
            "best_case_served": _measure_best_case(name, dev)
            if name.startswith("scheme") else None,
            "uniform_cycles": uniform_cycles[name],
        })
    print("\n== Scheme comparison (paper §III-B) ==")
    print(table(rows, list(rows[0].keys())))
    print(f"on {where(dev)}")
    emit("tab_schemes", rows, {"alpha": alpha, "device": str(dev)})
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    run(device=ap.parse_args().device)
