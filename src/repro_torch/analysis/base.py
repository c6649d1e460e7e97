"""Shared vocabulary of the port's static-analysis layers
(``repro.analysis.base`` counterpart).

A *finding* is one violated invariant, anchored to a file and line when
the analyzer works from source (the repo rules) or to a logical location
(a scheme name, a sweep-point signature, a carry variant) when it works
from live objects (the GF(2) verifier, the carry lint). Analyzers return
``list[Finding]``: empty means the invariant holds; the CLI turns a
non-empty list into a non-zero exit under ``--strict``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Optional

# repo-root anchor: src/repro_torch/analysis/base.py -> three dirs up
REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))
SRC_ROOT = os.path.join(REPO_ROOT, "src")
PORT_ROOT = os.path.join(SRC_ROOT, "repro_torch")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant."""

    rule: str                    # stable rule id, e.g. "oracle-purity"
    location: str                # "path:line" or a logical anchor
    message: str                 # what is wrong and why it matters
    line: Optional[int] = None   # 1-based, when source-anchored

    def __str__(self) -> str:
        return f"[{self.rule}] {self.location}: {self.message}"


def rel(path: str) -> str:
    """Repo-relative form of ``path`` for stable finding locations."""
    try:
        return os.path.relpath(path, REPO_ROOT)
    except ValueError:                                    # pragma: no cover
        return path


def format_findings(findings: Iterable[Finding]) -> str:
    return "\n".join(str(f) for f in findings)


def python_files(root: str) -> List[str]:
    """All ``.py`` files under ``root``, sorted for deterministic output."""
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        out.extend(os.path.join(dirpath, f) for f in filenames
                   if f.endswith(".py"))
    return sorted(out)
