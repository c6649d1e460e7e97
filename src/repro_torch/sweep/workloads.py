"""Workload registry: named scenario suites + trace materialization and
stacking; the port of ``repro/sweep/workloads.py``.

A suite is a function returning a list of ``SweepPoint``s; ``build_trace``
materializes one point's trace through the port's ``repro_torch.sim.trace``
generators or, for ``trace="file:<path>"`` points, through
``repro_torch.traces.formats.load_trace`` (``file_point`` sizes a point to
an on-disk trace); ``stack_traces`` turns shape-compatible traces into one
``Trace`` with a leading point axis (what the engine runs lock-step).
Trace generation is seeded NumPy, so every suite is deterministic per seed.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.system import Trace
from repro_torch.sim.trace import TRACES, TraceSpec
from repro_torch.sweep.grid import SweepPoint, grid


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


def file_point(path: str, base: SweepPoint = SweepPoint(), **kw) -> SweepPoint:
    """A SweepPoint sized to an on-disk ``.npz`` trace: ``n_cores``/``length``
    are probed from the file so the batched engine's shape check passes."""
    from repro_torch.traces.formats import probe
    n_cores, length = probe(path)
    return base.replace(trace=f"file:{path}", n_cores=n_cores, length=length,
                        **kw)


def text_file_point(path: str, base: SweepPoint = SweepPoint(), *,
                    line_bytes: int = 1, format: Optional[str] = None,
                    **kw) -> SweepPoint:
    """A SweepPoint sized to a Ramulator/gem5 *text* trace: the request
    count is probed (one lazy parse) and ``length`` set to the per-core
    columns the round-robin deal needs under ``base.n_cores``; the mapping
    options ride ``trace_kwargs`` into ingestion."""
    from repro_torch.traces.formats import count_requests
    n = count_requests(path, format=format)
    tkw = [("line_bytes", line_bytes)]
    if format is not None:
        tkw.append(("format", format))
    return base.replace(trace=f"file:{path}", length=-(-n // base.n_cores),
                        trace_kwargs=tuple(tkw), **kw)


def stack_traces(traces: Sequence[Trace]) -> Trace:
    """Stack shape-compatible traces along a new leading point axis."""
    shapes = {tuple(t.bank.shape) for t in traces}
    if len(shapes) != 1:
        raise ValueError(f"cannot batch traces of mixed shapes: {shapes}")
    return Trace(*(torch.stack(xs) for xs in zip(*traces)))


# --------------------------------------------------------------------- suites
def trace_zoo(base: SweepPoint = SweepPoint(), *,
              seeds: Sequence[int] = (0, 1),
              traces: Sequence[str] = ("banded", "split", "ramp", "uniform",
                                       "zipf")) -> List[SweepPoint]:
    """Every trace generator × seed on one memory configuration — the
    one-batch scenario spread (all points are shape-compatible)."""
    return grid(base, trace=traces, seed=seeds)


def multi_seed(base: SweepPoint = SweepPoint(), *,
               n_seeds: int = 8) -> List[SweepPoint]:
    """Seed replication of a single scenario (confidence intervals)."""
    return grid(base, seed=range(n_seeds))


def tunable_grid(base: SweepPoint = SweepPoint(), *,
                 select_periods: Sequence[int] = (32, 64, 256),
                 wq_his: Sequence[int] = (4, 8)) -> List[SweepPoint]:
    """Controller-knob exploration — one batch."""
    return grid(base, select_period=select_periods, wq_hi=wq_his)


def paper_fig18(base: SweepPoint = SweepPoint(), *,
                schemes: Sequence[str] = ("scheme_i", "scheme_ii",
                                          "scheme_iii"),
                alphas: Sequence[float] = (0.05, 0.1, 0.25, 0.5, 1.0),
                r: float = 0.05) -> List[SweepPoint]:
    """Fig 18 axes: scheme × α on the dedup-like banded trace, plus the
    uncoded baseline. ``partition`` batches each scheme's α < 1 points
    together (traced geometry) and its α = 1 point alone."""
    base = base.replace(trace="banded", r=r)
    pts = [base.replace(scheme="uncoded", alpha=1.0)]
    pts += grid(base, scheme=schemes, alpha=alphas)
    return pts


def paper_fig19(base: SweepPoint = SweepPoint(), *,
                rs: Sequence[float] = (0.05, 0.125, 0.25),
                alphas: Sequence[float] = (0.1, 0.25, 0.5, 1.0),
                n_bands: int = 8) -> List[SweepPoint]:
    """Fig 19 axes: α × r for scheme I on the split-band augmentation."""
    base = base.replace(trace="split", trace_kwargs=(("n_bands", n_bands),),
                        scheme="scheme_i")
    pts = [base.replace(scheme="uncoded", alpha=1.0, r=0.05)]
    pts += grid(base, r=rs, alpha=alphas)
    return pts


def drift_label(drift: float) -> str:
    """Label every ``paper_fig20`` point carries; consumers select records
    with this instead of re-deriving the format."""
    return f"drift={drift}"


def paper_fig20(base: SweepPoint = SweepPoint(), *,
                drifts: Sequence[float] = (0.0, 0.25, 1.0),
                alphas: Sequence[float] = (0.1, 0.25)) -> List[SweepPoint]:
    """Fig 20 axes: band drift × α (static bands vs slow/fast linear ramp).
    All points — including drift=0 — are labeled ``drift_label(drift)``."""
    pts: List[SweepPoint] = []
    for drift in drifts:
        space = base.n_banks * base.n_rows
        tbase = (base.replace(trace="banded") if drift == 0.0 else
                 base.replace(trace="ramp",
                              trace_kwargs=(("drift_total", space * drift),)))
        tbase = tbase.replace(label=drift_label(drift))
        pts.append(tbase.replace(scheme="uncoded", alpha=1.0))
        pts += grid(tbase.replace(scheme="scheme_i"), alpha=alphas)
    return pts


SCENARIO_EXTENSIONS = (".trace", ".gem5", ".csv", ".npz")


def scenario_pack(base: SweepPoint = SweepPoint(), *,
                  directory: Optional[str] = None,
                  line_bytes: int = 64,
                  alphas: Sequence[float] = (0.25,)) -> List[SweepPoint]:
    """Trace files as sweep points: every supported trace file under
    ``directory`` (sorted; Ramulator/gem5 text and canonical ``.npz``) × α,
    each point sized to its file and labeled with the file stem."""
    if directory is None:
        raise ValueError(
            "scenario_pack needs directory=<folder of trace files> "
            "(the checked-in pack lives in tests/data/scenarios/)")
    paths = sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if f.endswith(SCENARIO_EXTENSIONS))
    if not paths:
        raise ValueError(f"no trace files under {directory!r} "
                         f"(looked for {SCENARIO_EXTENSIONS})")
    pts: List[SweepPoint] = []
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        if path.endswith(".npz"):
            pt = file_point(path, base, label=stem)
        else:
            pt = text_file_point(path, base, line_bytes=line_bytes,
                                 label=stem)
        pts.extend(pt.replace(alpha=a) for a in alphas)
    return pts


SUITES: Dict[str, Callable[..., List[SweepPoint]]] = {
    "trace_zoo": trace_zoo,
    "multi_seed": multi_seed,
    "tunable_grid": tunable_grid,
    "paper_fig18": paper_fig18,
    "paper_fig19": paper_fig19,
    "paper_fig20": paper_fig20,
    "scenario_pack": scenario_pack,
}


def suite(name: str, base: SweepPoint = SweepPoint(), **kw) -> List[SweepPoint]:
    """The named suite's points, each stamped with the suite's name so
    errors and result rows can name their origin."""
    if name not in SUITES:
        raise KeyError(f"unknown suite {name!r}; have {sorted(SUITES)}")
    return [pt.replace(suite=name) for pt in SUITES[name](base, **kw)]
