"""Config-grid layer: sweep points, static-shape partitioning, grid helpers;
the port's copy of ``repro/sweep/grid.py`` (plain python).

A design-space sweep (scheme × α × r × trace-shape × seed × tunables) mixes
two kinds of coordinates:

  * **static** coordinates that change array *shapes* inside the simulator —
    scheme tables, ``n_rows``, α/r (via ``n_slots``/``region_size``), queue
    depths, trace geometry. Points differing here need separate batches.
  * **batchable** coordinates that only change array *values* — seeds, trace
    generator + its kwargs, write fractions, ``select_period``/``wq_lo``/
    ``wq_hi``. Points differing *only* here run lock-step in one batch,
    the point index a leading tensor axis.

α and r sit in between: they only enter the simulator through the parity
slot count ``n_slots = ⌊α/r⌋`` and the region geometry
``region_size``/``n_regions`` — shapes, but *maskable* ones. Points that
share every other structural coordinate (and full-coverage status) get
region/parity state allocated at the **group maxima** of all three, and
each point's own geometry rides along as the traced
``TunableParams.{n_slots,region_size,n_regions}_active`` — indexing uses
the traced values and the padding is masked off. An α×r grid therefore
partitions per *(scheme, full-coverage)* group, not per r and not per
(α, r) pair.

``partition`` groups points by their static signature so the engine runs a
whole sweep as ``len(partition(points))`` device programs instead of
``len(points)``. In the port a "program" is one batched loop over the
point axis (``repro_torch.sweep.engine``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.state import derive_geometry
from repro_torch.core.system import drain_bound


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One configuration in a design-space sweep (all plain python values)."""

    # ---- static: memory-system geometry (a separate batch per value)
    scheme: str = "scheme_i"
    n_rows: int = 320
    alpha: float = 1.0
    r: float = 0.05
    n_data: int = 8
    queue_depth: int = 10
    coalesce: bool = True
    recode_cap: int = 64
    max_syms: int = 96
    encode_rows_per_cycle: int = 64
    recode_budget: int = 4
    # ---- static: trace geometry
    n_cores: int = 8
    n_banks: int = 8
    length: int = 96
    n_cycles: Optional[int] = None   # None = drain bound from length/n_cores
    # ---- static: observability (the telemetry planes,
    # ``repro_torch.obs.planes``) and fault injection: a flat spec of
    # ("bank", b, fail_at[, recover_at]) and ("stutter", port, period[,
    # phase]) entries, () = no faults. Only the *presence* of a plan is
    # static (the system carries the fault leaf); points with different
    # plans share one batch, their schedules stacked per point.
    telemetry: bool = False
    faults: Tuple[Tuple, ...] = ()
    # ---- batchable: trace contents
    trace: str = "banded"            # name in repro_torch.sim.trace.TRACES, or
                                     # "file:<path>" for an ingested on-disk
                                     # trace (repro_torch.traces.formats)
    trace_kwargs: Tuple[Tuple[str, Any], ...] = ()
    seed: int = 0
    write_frac: float = 0.3
    issue_prob: float = 1.0
    # ---- batchable: tunables (traced scalars in the cycle engine)
    select_period: int = 256
    wq_hi: int = 8
    wq_lo: int = 2
    # free-form tag carried through to result rows
    label: str = ""
    # provenance metadata (not a simulation coordinate): the registry suite
    # that produced this point, stamped by ``workloads.suite`` so error
    # messages and result rows can name their origin
    suite: str = ""

    def derived_slots(self) -> Tuple[int, int, int]:
        """(region_size, n_regions, n_slots) this point's α/r imply."""
        return derive_geometry(self.n_rows, self.alpha, self.r)

    def full_coverage(self) -> bool:
        _, n_regions, n_slots = self.derived_slots()
        return n_slots >= n_regions

    def replace(self, **kw) -> "SweepPoint":
        return dataclasses.replace(self, **kw)

    def resolved_cycles(self) -> int:
        if self.n_cycles is not None:
            return int(self.n_cycles)
        return drain_bound(self.n_cores, self.length)


def static_signature(pt: SweepPoint) -> Tuple:
    """Hashable key of everything that forces a distinct batch.

    α and r are deliberately *not* part of the key: their shape effects
    (``n_slots`` and ``region_size``/``n_regions``) are allocated at the
    group maxima and masked per point via the traced
    ``TunableParams.{n_slots,region_size,n_regions}_active``. Only the
    full-coverage *status* stays in the key — full-coverage points run with
    the dynamic-coding unit statically disabled (identity region map), a
    genuinely different program.
    """
    _, n_regions, n_slots = pt.derived_slots()
    full = n_slots >= n_regions
    return (pt.scheme, pt.n_data, pt.n_rows, full,
            pt.queue_depth, pt.coalesce, pt.recode_cap, pt.max_syms,
            pt.encode_rows_per_cycle, pt.recode_budget,
            pt.n_cores, pt.n_banks, pt.length, pt.resolved_cycles(),
            pt.telemetry, bool(pt.faults))


def batch_geometry_alloc(points: Sequence[SweepPoint]) -> Tuple[int, int, int]:
    """(region_size, n_regions, n_slots) allocation for one shape-compatible
    batch: the per-coordinate maxima over the group (for a single-geometry
    group this is exactly the derived geometry — zero padding)."""
    geoms = [pt.derived_slots() for pt in points]
    return (max(g[0] for g in geoms), max(g[1] for g in geoms),
            max(g[2] for g in geoms))


@dataclasses.dataclass
class GridBatch:
    """All shape-compatible points of one sweep, plus their original indices."""

    signature: Tuple
    indices: List[int]
    points: List[SweepPoint]

    def __len__(self) -> int:
        return len(self.points)


def partition(points: Sequence[SweepPoint]) -> List[GridBatch]:
    """Group points by static signature, preserving first-seen batch order."""
    batches: Dict[Tuple, GridBatch] = {}
    for i, pt in enumerate(points):
        sig = static_signature(pt)
        b = batches.get(sig)
        if b is None:
            b = batches[sig] = GridBatch(sig, [], [])
        b.indices.append(i)
        b.points.append(pt)
    return list(batches.values())


def grid(base: Optional[SweepPoint] = None, **axes: Iterable) -> List[SweepPoint]:
    """Cartesian product over SweepPoint fields.

    >>> grid(alpha=(0.1, 0.25), seed=range(4))        # 8 points
    Axis order follows kwargs order; the last axis varies fastest.
    """
    base = base or SweepPoint()
    names = list(axes)
    bad = [n for n in names if n not in SweepPoint.__dataclass_fields__]
    if bad:
        raise ValueError(f"unknown SweepPoint fields: {bad}")
    values = [list(axes[n]) for n in names]
    return [base.replace(**dict(zip(names, combo)))
            for combo in itertools.product(*values)]
