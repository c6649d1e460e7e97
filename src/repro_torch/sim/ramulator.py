"""Trace-driven evaluation driver (the paper's modified-Ramulator stage,
§V-B), port of ``repro/sim/ramulator.py``.

``simulate`` runs one (scheme, α, r) configuration over a trace and returns
a ``SimResult`` — the looped per-point reference path. ``compare_schemes``
and ``sweep_alpha`` reproduce the paper's figure axes (CPU cycles and
dynamic-coding region switches vs α, per scheme, against the uncoded
baseline) and are thin wrappers over the batched ``repro_torch.sweep``
engine: points sharing a static shape run lock-step as one batch, each
equal to its looped ``simulate``. All of them run on the CUDA card unless
given ``device="cpu"``.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

from repro_torch.core.codes import get_tables
from repro_torch.core.state import make_params, make_tunables
from repro_torch.core.system import (CodedMemorySystem, SimResult, Trace,
                                     drain_bound)
from repro_torch.kernels.common import resolve_device


def default_n_cycles(trace: Trace) -> int:
    """Cycle budget for a materialized trace (``drain_bound``)."""
    return drain_bound(int(trace.bank.shape[0]), int(trace.bank.shape[1]))


def simulate(
    scheme: str,
    trace: Trace,
    n_rows: int,
    alpha: float = 1.0,
    r: float = 0.05,
    n_data: int = 8,
    n_cycles: Optional[int] = None,
    select_period: int = 256,
    wq_hi: int = 8,
    wq_lo: int = 2,
    device=None,
    return_state: bool = False,
    on_cycle: Optional[Callable] = None,
    **kw,
):
    """One configuration over ``trace`` for all ``n_cycles`` cycles, on the
    card unless ``device`` names another (the trace moves there). Returns
    the ``SimResult``, or ``(SimResult, final SimState)`` with
    ``return_state``. ``on_cycle(before, after, out)`` sees every cycle.
    ``**kw`` goes to ``make_params``."""
    dev = resolve_device(device)
    tables = get_tables(scheme, n_data=n_data)
    p = make_params(tables, n_rows=n_rows, alpha=alpha, r=r, **kw)
    tn = make_tunables(queue_depth=p.queue_depth, select_period=select_period,
                       wq_hi=wq_hi, wq_lo=wq_lo)
    trace = Trace(*(x.to(dev) for x in trace))
    sys_ = CodedMemorySystem(tables, p, n_cores=trace.bank.shape[0],
                             tunables=tn, device=dev)
    if n_cycles is None:
        n_cycles = default_n_cycles(trace)
    st, _ = sys_._run(sys_.init(), trace, n_cycles, on_cycle=on_cycle)
    res = sys_.summarize(st)
    return (res, st) if return_state else res


def sweep_point(
    scheme: str,
    trace: Trace,
    n_rows: int,
    alpha: float = 1.0,
    r: float = 0.05,
    n_data: int = 8,
    n_cycles: Optional[int] = None,
    select_period: int = 256,
    wq_hi: int = 8,
    wq_lo: int = 2,
    **kw,
):
    """Map ``simulate``-style kwargs + a materialized trace to a SweepPoint.

    ``**kw`` forwards the remaining ``make_params`` knobs (queue_depth,
    coalesce, recode_cap, max_syms, encode_rows_per_cycle, recode_budget),
    which are all SweepPoint fields.
    """
    from repro_torch.sweep.grid import SweepPoint
    n_cores, length = (int(d) for d in trace.bank.shape)
    return SweepPoint(
        scheme=scheme, n_rows=n_rows, alpha=alpha, r=r, n_data=n_data,
        n_cores=n_cores, length=length,
        n_cycles=n_cycles if n_cycles is not None else default_n_cycles(trace),
        trace="custom", select_period=select_period, wq_hi=wq_hi, wq_lo=wq_lo,
        **kw,
    )


def compare_schemes(
    trace: Trace,
    n_rows: int,
    alpha: float = 1.0,
    r: float = 0.05,
    schemes: Iterable[str] = ("uncoded", "scheme_i", "scheme_ii",
                              "scheme_iii"),
    device=None,
    **kw,
) -> Dict[str, SimResult]:
    """Each scheme over ``trace`` at one (α, r), through ``run_points``."""
    from repro_torch.sweep.engine import run_points
    schemes = list(schemes)
    pts = [sweep_point(s, trace, n_rows, alpha=alpha, r=r, **kw)
           for s in schemes]
    return dict(zip(schemes, run_points(pts, traces=[trace] * len(pts),
                                        device=device)))


def sweep_alpha(
    scheme: str,
    trace: Trace,
    n_rows: int,
    alphas: Iterable[float] = (0.05, 0.1, 0.25, 0.5, 1.0),
    r: float = 0.05,
    device=None,
    **kw,
) -> Dict[float, SimResult]:
    """One scheme over ``trace`` at each α, through ``run_points``."""
    from repro_torch.sweep.engine import run_points
    alphas = list(alphas)
    pts = [sweep_point(scheme, trace, n_rows, alpha=a, r=r, **kw)
           for a in alphas]
    return dict(zip(alphas, run_points(pts, traces=[trace] * len(pts),
                                       device=device)))


def cycle_reduction(baseline: SimResult, coded: SimResult) -> float:
    """Fractional CPU-cycle reduction vs the uncoded baseline (Fig 18 axis)."""
    return 1.0 - coded.cycles / max(baseline.cycles, 1)
