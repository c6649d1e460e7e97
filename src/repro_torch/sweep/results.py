"""Results store: flat per-point tables, JSON/CSV export, baseline columns;
the port of ``repro/sweep/results.py`` (plain python: rows, JSON and CSV
equal the JAX package's for the same results).

``SweepResultSet`` holds (SweepPoint, SimResult) records in sweep order and
renders them as flat rows — config coordinates first, then every SimResult
field — plus optional baseline-normalized columns (``baseline_cycles``,
``speedup``, ``cycle_reduction_%``) computed by matching each point to the
baseline record that shares its workload coordinates.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.system import SimResult
from repro_torch.sweep.grid import SweepPoint

POINT_COLS: Tuple[str, ...] = (
    "label", "scheme", "alpha", "r", "n_rows", "trace", "seed", "write_frac",
    "issue_prob", "n_cores", "n_banks", "length", "queue_depth",
    "select_period", "wq_hi", "wq_lo", "suite",
)
RESULT_COLS: Tuple[str, ...] = SimResult._fields
BASELINE_COLS: Tuple[str, ...] = ("baseline_cycles", "speedup",
                                  "cycle_reduction_%")

# workload coordinates a baseline must share to normalize a point
DEFAULT_MATCH: Tuple[str, ...] = (
    "trace", "trace_kwargs", "seed", "write_frac", "issue_prob", "n_rows",
    "n_cores", "n_banks", "length",
)


def _is_uncoded(pt: SweepPoint) -> bool:
    return pt.scheme == "uncoded"


@dataclasses.dataclass(frozen=True)
class SweepRecord:
    point: SweepPoint
    result: SimResult

    def row(self) -> Dict:
        r = {c: getattr(self.point, c) for c in POINT_COLS}
        if self.point.trace_kwargs:
            r["trace_kwargs"] = json.dumps(dict(self.point.trace_kwargs))
        r.update({c: getattr(self.result, c) for c in RESULT_COLS})
        return r


class SweepResultSet:
    def __init__(self, records: Sequence[SweepRecord]):
        self.records: List[SweepRecord] = list(records)

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    # ------------------------------------------------------------------ rows
    def rows(self, baseline: Optional[Callable[[SweepPoint], bool]] = _is_uncoded,
             match: Sequence[str] = DEFAULT_MATCH) -> List[Dict]:
        """Flat rows; when any baseline records exist, each row that has a
        workload-matched baseline gains the normalized speedup columns.

        Raises ``ValueError`` if several distinct baseline records share one
        match key (which baseline to normalize against would be arbitrary) —
        extend ``match`` with the coordinate that distinguishes them.
        """
        rows = [rec.row() for rec in self.records]
        if baseline is None:
            return rows
        key = lambda pt: tuple(getattr(pt, c) for c in match)  # noqa: E731
        base_cycles: Dict[Tuple, int] = {}
        for rec in self.records:
            if baseline(rec.point):
                k = key(rec.point)
                if k in base_cycles and base_cycles[k] != rec.result.cycles:
                    raise ValueError(
                        f"ambiguous baseline for match key {dict(zip(match, k))}: "
                        f"multiple baseline records with different cycles — "
                        f"add the distinguishing coordinate to `match`")
                base_cycles[k] = rec.result.cycles
        for rec, row in zip(self.records, rows):
            b = base_cycles.get(key(rec.point))
            if b is None:
                continue
            row["baseline_cycles"] = b
            row["speedup"] = round(b / max(rec.result.cycles, 1), 4)
            row["cycle_reduction_%"] = round(
                100.0 * (1.0 - rec.result.cycles / max(b, 1)), 2)
        return rows

    # ---------------------------------------------------------------- export
    def to_json(self, path: str, meta: Optional[Dict] = None, **rows_kw) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"meta": meta or {}, "rows": self.rows(**rows_kw)}, f,
                      indent=1, default=float)
        return path

    def to_csv(self, path: str, **rows_kw) -> str:
        rows = self.rows(**rows_kw)
        cols: List[str] = []
        for r in rows:
            for c in r:
                if c not in cols:
                    cols.append(c)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols, restval="")
            w.writeheader()
            w.writerows(rows)
        return path

    # --------------------------------------------------------------- lookups
    def by(self, **coords) -> List[SweepRecord]:
        """Records whose point matches every given coordinate exactly."""
        return [rec for rec in self.records
                if all(getattr(rec.point, k) == v for k, v in coords.items())]

    def one(self, **coords) -> SweepRecord:
        hits = self.by(**coords)
        if len(hits) != 1:
            raise KeyError(f"{coords} matched {len(hits)} records")
        return hits[0]
