"""Shared harness utilities: result table formatting + JSON artefacts; the
port's counterpart of ``benchmarks/common.py``'s ``emit``, ``table`` and
``_fmt``.

``emit`` writes only ``experiments/torch/<name>.json`` (git-ignored), with
the port's run manifest (``repro_torch.obs.runlog``: commit, torch and
CUDA, each card's name and power limit). The root-level ``BENCH_*.json``
files are the JAX package's CPU records; the port never writes them.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

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
