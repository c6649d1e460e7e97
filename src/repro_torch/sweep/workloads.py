"""Trace materialization and stacking for the sweep engine; the port's copy
of what the engine needs from ``repro/sweep/workloads.py``.

``build_trace`` materializes one point's trace through the port's
``repro_torch.sim.trace`` generators or, for ``trace="file:<path>"``
points, through ``repro_torch.traces.formats.load_trace``;
``stack_traces`` turns shape-compatible traces into one ``Trace`` with a
leading point axis (what the engine runs lock-step). Trace generation is
seeded NumPy, so a point's trace is deterministic per seed.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from repro_torch.core.system import Trace
from repro_torch.sim.trace import TRACES, TraceSpec
from repro_torch.sweep.grid import SweepPoint


def _point_name(pt: SweepPoint, index: Optional[int]) -> str:
    """Human-readable identity of a failing point: its suite (when stamped)
    and sweep index, plus the distinguishing coordinates — a bare trace-key
    error is unattributable in a many-point sweep."""
    where = pt.suite or "<ad-hoc sweep>"
    idx = f"[{index}]" if index is not None else ""
    tag = f" label={pt.label!r}" if pt.label else ""
    return (f"SweepPoint {where}{idx}{tag} (scheme={pt.scheme}, "
            f"trace={pt.trace!r}, seed={pt.seed})")


def build_trace(pt: SweepPoint, *, index: Optional[int] = None,
                device=None) -> Trace:
    """Materialize one sweep point's request streams on ``device`` (the
    card unless the caller names another).

    ``pt.trace`` is either a generator name from
    ``repro_torch.sim.trace.TRACES`` or ``"file:<path>"`` for an on-disk
    trace ingested via ``repro_torch.traces.formats.load_trace``
    (``trace_kwargs`` forwards the mapping options — ``format``,
    ``line_bytes``; bank/row geometry comes from the point). ``index`` is
    the point's position in its sweep, used to attribute errors.
    """
    if pt.trace.startswith("file:"):
        from repro_torch.traces.formats import load_trace
        path = pt.trace[len("file:"):]
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{_point_name(pt, index)}: trace file {path!r} not found")
        try:
            tr = load_trace(path, n_cores=pt.n_cores, n_banks=pt.n_banks,
                            n_rows=pt.n_rows, length=pt.length,
                            device=device, **dict(pt.trace_kwargs))
        except ValueError as e:      # e.g. the file outgrows pt.length
            raise ValueError(f"{_point_name(pt, index)}: {e}") from None
        got = tuple(int(d) for d in tr.bank.shape)
        if got != (pt.n_cores, pt.length):
            raise ValueError(
                f"{_point_name(pt, index)}: file trace shape {got} does not "
                f"match the point geometry ({pt.n_cores}, {pt.length}) — "
                f"size the point with workloads.file_point()")
        # an .npz carries pre-mapped bank/row streams: a file saved from a
        # different memory geometry would index out of range
        max_b, max_r = (max(v, 0) for v in (
            torch.stack([tr.bank.max(), tr.row.max()]).tolist()
            if tr.bank.numel() else (0, 0)))
        if max_b >= pt.n_banks or max_r >= pt.n_rows:
            raise ValueError(
                f"{_point_name(pt, index)}: file trace addresses bank "
                f"{max_b}/row {max_r} but the point geometry is n_banks="
                f"{pt.n_banks}, n_rows={pt.n_rows} — the file was mapped "
                f"for a different memory geometry")
        return tr
    gen = TRACES.get(pt.trace)
    if gen is None:
        raise KeyError(f"{_point_name(pt, index)}: unknown trace generator "
                       f"{pt.trace!r}; have {sorted(TRACES)} or 'file:<path>'")
    spec = TraceSpec(n_cores=pt.n_cores, length=pt.length, n_banks=pt.n_banks,
                     n_rows=pt.n_rows, issue_prob=pt.issue_prob,
                     write_frac=pt.write_frac, seed=pt.seed)
    return gen(spec, device=device, **dict(pt.trace_kwargs))


def stack_traces(traces: Sequence[Trace]) -> Trace:
    """Stack shape-compatible traces along a new leading point axis."""
    shapes = {tuple(t.bank.shape) for t in traces}
    if len(shapes) != 1:
        raise ValueError(f"cannot batch traces of mixed shapes: {shapes}")
    return Trace(*(torch.stack(xs) for xs in zip(*traces)))
