"""Shared harness utilities: result table formatting + JSON artefacts; the
port's counterpart of ``benchmarks/common.py``'s ``emit``, ``table`` and
``_fmt``. ``run_grid`` and ``report_batches`` run a figure's grid through
``run_sweep`` on a device and print each batch's batched cycles against
``drain_bound`` and the grid's wall time, with the card and its power
limit.

``emit`` writes only ``experiments/torch/<name>.json`` (git-ignored), with
the port's run manifest (``repro_torch.obs.runlog``: commit, torch and
CUDA, each card's name and power limit). The root-level ``BENCH_*.json``
files are the JAX package's CPU records; the port never writes them.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs import runlog

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                         "..", ".."))
ART_DIR = os.path.join(REPO_ROOT, "experiments", "torch")


def emit(name: str, rows: List[Dict[str, Any]],
         meta: Optional[Dict[str, Any]] = None,
         headline: Optional[Dict[str, Any]] = None,
         timings: Optional[Dict[str, float]] = None) -> str:
    """Write ``experiments/torch/<name>.json``: the rows, ``meta``, a
    one-line ``headline`` and the run manifest (``timings`` lands there)."""
    os.makedirs(ART_DIR, exist_ok=True)
    blob = {"name": name, "meta": meta or {},
            "manifest": runlog.run_manifest(timings=timings),
            "headline": headline or {}, "rows": rows}
    path = os.path.join(ART_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(blob, f, indent=1, default=float)
    return path


def table(rows: List[Dict[str, Any]], cols: List[str]) -> str:
    if not rows:
        return "(empty)"
    widths = {c: max(len(c), max(len(_fmt(r.get(c))) for r in rows))
              for c in cols}
    head = " | ".join(c.ljust(widths[c]) for c in cols)
    sep = "-+-".join("-" * widths[c] for c in cols)
    body = "\n".join(
        " | ".join(_fmt(r.get(c)).ljust(widths[c]) for c in cols)
        for r in rows)
    return f"{head}\n{sep}\n{body}"


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1e5 or abs(v) < 1e-3:
            return f"{v:.3e}"
        return f"{v:.4g}"
    return str(v)


class BatchCycles:
    """``run_sweep``'s ``on_cycle``: counts each batch's batched cycles,
    then calls ``inner`` (the caller's hook) when given."""

    def __init__(self, inner=None):
        self.inner, self.cycles = inner, {}

    def __call__(self, batch, before, after, out):
        key = tuple(batch.indices)
        self.cycles[key] = self.cycles.get(key, 0) + 1
        if self.inner is not None:
            self.inner(batch, before, after, out)


def where(dev: torch.device) -> str:
    """The device a grid ran on: the card's name and power limit, or the
    CPU."""
    if dev.type != "cuda":
        return f"the {dev.type.upper()}"
    cards = runlog.card_lines()
    return cards[0] if cards else torch.cuda.get_device_name(dev)


def run_grid(pts, dev: torch.device, on_cycle=None):
    """``run_sweep(pts)`` on ``dev``: (the ``SweepResultSet``, the
    ``BatchCycles`` counter, wall seconds). ``on_cycle(batch, before,
    after, out)`` sees every batched cycle when given."""
    from repro_torch.sweep import run_sweep

    counter = BatchCycles(on_cycle)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rs = run_sweep(pts, device=dev, on_cycle=counter)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return rs, counter, time.perf_counter() - t0


def report_batches(pts, counter: BatchCycles, secs: float,
                   dev: torch.device) -> List[Dict[str, Any]]:
    """Print each batch's batched cycles against ``drain_bound`` and the
    grid's wall time; returns ``[{"points", "batched_cycles"}]`` per
    batch, for the artefact."""
    from repro_torch.sweep import partition
    from repro_torch.sweep.engine import mixed_geometry

    bound = pts[0].resolved_cycles()
    batches = []
    for b in partition(pts):
        n = counter.cycles.get(tuple(b.indices), 0)
        scheme = b.points[0].scheme
        slots = ("" if scheme == "uncoded" else ", parity slots "
                 f"{[pt.derived_slots()[2] for pt in b.points]}")
        geometry = "traced" if mixed_geometry(b.points) else "uniform"
        print(f"batch {scheme} alpha {[pt.alpha for pt in b.points]} "
              f"(B={len(b)}{slots}, {geometry} region geometry): {n} "
              f"batched cycles against drain_bound {bound}")
        batches.append({"points": b.indices, "batched_cycles": n})
    n_batched = sum(b["batched_cycles"] for b in batches)
    print(f"grid: {len(pts)} points in {len(batches)} batches, {n_batched} "
          f"batched cycles ({len(pts)} x {bound} looped), wall {secs:.2f} s "
          f"on {where(dev)}")
    return batches
