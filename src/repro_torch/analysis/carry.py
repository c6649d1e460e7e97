"""Layer 2: the carry lint, the port's counterpart of
``repro/analysis/jaxpr.py``.

torch has no jaxpr, so each of that file's guarantees is proved on live
objects at a small size, on the card unless the caller names the CPU:

* **Signature completeness** — ``run_batch`` builds one system from the
  first point of a ``static_signature`` class. So every point of a class
  must give the same ``MemParams`` at the class's allocation
  (``engine.params_for``) and an initial state of the same leaf
  structure, shapes, dtypes and devices: a static coordinate leaking out
  of the key would run the other points on the leader's program.
* **Carry stability** — one ``cycle_batch`` and one ``run_chunk_batch``
  return exactly the input state's structure and each leaf's shape, dtype
  and device, ``tele`` and ``fault`` included (flags off, telemetry on,
  faults on, a traced padded geometry); so does the pooled decode step's
  cache (off, telemetry on, uncoded, ``recode_budget=-1``). On the card a
  leaf that drifts to another device is a finding.
* **Flag-off identity** — with telemetry and faults off, ``tele is None``
  and ``fault is None``; the ATen ops of one cycle, recorded with a
  ``TorchDispatchMode``, are the same sequence whether the flags are
  passed as ``False`` or left at their defaults, and each flag on records
  another; the serve step's telemetry-on, uncoded and ``recode_budget=-1``
  variants each record another sequence than the baseline step's.

Every check is a function of what it compares (``lint_carry``,
``fingerprint``, ``op_sequence``), so a fixture can hold each against an
injected drift.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.base import Finding


# ---------------------------------------------------------------- helpers
def fingerprint(tree) -> str:
    """A tree's structure (NamedTuple and dataclass types and fields, dict
    keys, None) and each tensor leaf's shape, dtype and device."""
    if isinstance(tree, torch.Tensor):
        return f"{tuple(tree.shape)}/{tree.dtype}/{tree.device}"
    if tree is None:
        return "None"
    if isinstance(tree, tuple):
        fields = getattr(tree, "_fields", range(len(tree)))
        return f"{type(tree).__name__}(" + ",".join(
            f"{f}={fingerprint(x)}" for f, x in zip(fields, tree)) + ")"
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}={fingerprint(tree[k])}"
                              for k in sorted(tree)) + "}"
    if dataclasses.is_dataclass(tree):
        return f"{type(tree).__name__}(" + ",".join(
            f"{f.name}={fingerprint(getattr(tree, f.name))}"
            for f in dataclasses.fields(tree)) + ")"
    return type(tree).__name__


def _first_drift(a: str, b: str) -> str:
    pa, pb = a.split(","), b.split(",")
    for x, y in zip(pa, pb):
        if x != y:
            return f"{x} -> {y}"
    return f"{len(pa)} -> {len(pb)} leaves"


def lint_carry(label: str, fn: Callable, carry, *args,
               pick: Optional[Callable] = None) -> List[Finding]:
    """Run ``fn(carry, *args)`` and require the output carry (``pick`` of
    the output; by default the output itself, or element 0 of a 2-tuple)
    to match ``carry`` exactly in structure and per-leaf shape, dtype and
    device. The input's fingerprint is taken before the call (a step may
    update its carry in place)."""
    before = fingerprint(carry)
    out = fn(carry, *args)
    if pick is not None:
        out = pick(out)
    elif isinstance(out, tuple) and len(out) == 2 and \
            not hasattr(out, "_fields"):
        out = out[0]
    after = fingerprint(out)
    if before != after:
        return [Finding(
            "carry-drift", label,
            "the carry is not structurally stable: "
            f"{_first_drift(before, after)} — every chunk or step would "
            "carry another layout (a dtype promoted, a leaf on another "
            "device, a leaf appearing)")]
    return []


class _OpLog(TorchDispatchMode):
    """Records the ATen op of every dispatched call."""

    def __init__(self):
        super().__init__()
        self.ops: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def op_sequence(fn: Callable, *args) -> List[str]:
    """The ATen ops ``fn(*args)`` dispatches, in order."""
    with _OpLog() as log:
        fn(*args)
    return log.ops


# ------------------------------------------------------- the sweep points
def default_lint_points() -> List:
    """The representative grid the CLI lints (JAX ``jaxpr.py:354``): an
    α × r × scheme × tunable spread exercising every signature-class
    mechanism (masked r axis, sub/full coverage split, telemetry and fault
    programs)."""
    from repro_torch.sweep.grid import SweepPoint, grid

    base = SweepPoint(n_rows=32, length=8)
    pts = grid(base, scheme=("scheme_i", "uncoded"),
               alpha=(0.25, 0.5), r=(0.125, 0.25),
               seed=(0, 1), select_period=(64, 128))
    pts += grid(base, alpha=(1.0,), r=(0.25,), seed=(0, 1))  # full coverage
    pts += [base.replace(telemetry=True),
            base.replace(faults=(("bank", 0, 2, 5),)),
            base.replace(faults=(("stutter", 1, 3),))]
    return pts


def _inputs(sys_, pts: Sequence, device):
    """The batched initial state, trace and tunables ``run_batch`` gives
    ``pts`` on ``sys_``."""
    from repro_torch.core.system import Trace
    from repro_torch.sweep import engine, workloads

    tn = engine.stack_tunables(pts, sys_.p.queue_depth, device)
    st = sys_.init_batch(tn, None, engine._stack_faults(pts, sys_.p, device))
    trace = Trace(*(x.to(device) for x in workloads.stack_traces(
        [workloads.build_trace(pt, index=i, device=device)
         for i, pt in enumerate(pts)])))
    return st, trace, tn


def lint_signature_classes(points: Sequence, device) -> List[Finding]:
    """Within each ``static_signature`` class every point gives the
    leader's ``MemParams`` at the class's allocation and an initial state
    of the leader's layout."""
    from repro_torch.core.codes import get_tables
    from repro_torch.core.system import CodedMemorySystem
    from repro_torch.sweep import engine
    from repro_torch.sweep.grid import batch_geometry_alloc, partition

    out: List[Finding] = []
    for batch in partition(list(points)):
        pts = batch.points
        alloc = batch_geometry_alloc(pts)
        traced = engine.mixed_geometry(pts)
        label = f"signature:{batch.signature}"
        lead = engine.params_for(pts[0], alloc, traced)
        prints: Dict[str, int] = {}
        for k, pt in enumerate(pts):
            p = engine.params_for(pt, alloc, traced)
            if p != lead:
                out.append(Finding(
                    "carry-static-leak", label,
                    f"member {k} builds other MemParams than member 0 at "
                    "the class's allocation — a static coordinate leaks "
                    "out of the class key, and run_batch would run the "
                    "point on member 0's system"))
                continue
            sys_ = CodedMemorySystem(get_tables(pt.scheme, n_data=pt.n_data),
                                     p, n_cores=pt.n_cores, device=device)
            prints.setdefault(fingerprint(_inputs(sys_, [pt], device)), k)
        if len(prints) > 1:
            ks = sorted(prints.values())
            out.append(Finding(
                "carry-static-leak", label,
                f"members {ks[0]} and {ks[1]} of one class start from "
                "initial states of another layout"))
    return out


# --------------------------------------------------------- carry stability
def lint_carry_stability(device, base=None) -> List[Finding]:
    """One ``cycle_batch`` and one ``run_chunk_batch`` (a batch of two
    points) map the carry to its own layout, in each variant."""
    from repro_torch.core.codes import get_tables
    from repro_torch.core.system import CodedMemorySystem
    from repro_torch.sweep import engine
    from repro_torch.sweep.grid import SweepPoint

    base = base if base is not None else SweepPoint(n_rows=32, length=8,
                                                    alpha=0.5, r=0.25)
    out: List[Finding] = []
    for label, pt, alloc in (
            ("flags-off", base, None),
            ("telemetry", base.replace(telemetry=True), None),
            ("faults", base.replace(faults=(("bank", 0, 2, 5),)), None),
            ("traced-geometry", base,
             tuple(2 * g for g in base.derived_slots()))):
        pts = [pt, pt.replace(seed=pt.seed + 1)]
        sys_ = CodedMemorySystem(
            get_tables(pt.scheme, n_data=pt.n_data),
            engine.params_for(pt, alloc, traced_geometry=alloc is not None),
            n_cores=pt.n_cores, device=device)
        st, trace, tn = _inputs(sys_, pts, device)
        out += lint_carry(f"cycle_batch[{label}]", sys_.cycle_batch, st,
                          trace, tn)
        out += lint_carry(f"run_chunk_batch[{label}]",
                          lambda s, *a: sys_.run_chunk_batch(s, *a), st,
                          trace, None, 4, tn, pick=lambda o: o)
    return out


# -------------------------------------------------------- flag-off identity
def lint_flag_identity(device, base=None) -> List[Finding]:
    """Flags off means absent leaves and the pre-flag program: the same
    ATen ops whether the flags are defaulted or passed False; each flag
    on changes them."""
    from repro_torch.core.codes import get_tables
    from repro_torch.core.state import make_params
    from repro_torch.core.system import CodedMemorySystem
    from repro_torch.sweep import engine
    from repro_torch.sweep.grid import SweepPoint

    base = base if base is not None else SweepPoint(n_rows=32, length=8,
                                                    alpha=0.5, r=0.25)
    tables = get_tables(base.scheme, n_data=base.n_data)

    def cycle_ops(params, pt):
        sys_ = CodedMemorySystem(tables, params, n_cores=pt.n_cores,
                                 device=device)
        st, trace, tn = _inputs(sys_, [pt], device)
        return st, op_sequence(sys_.cycle_batch, st, trace, tn)

    kw = dict(n_rows=base.n_rows, alpha=base.alpha, r=base.r,
              queue_depth=base.queue_depth)
    st, off = cycle_ops(make_params(tables, **kw), base)
    if st.mem.tele is not None or st.mem.fault is not None:
        return [Finding(
            "carry-flag-leak", "MemState[flags-off]",
            "telemetry or fault leaves present with the flags off — the "
            "flags-off carry must have the pre-flag structure (tele=None, "
            "fault=None)")]
    out: List[Finding] = []
    _, explicit = cycle_ops(make_params(tables, **kw, telemetry=False,
                                        faults=False), base)
    if explicit != off:
        out.append(Finding(
            "carry-flag-leak", "cycle_batch[flags-off]",
            "telemetry=False/faults=False records other ATen ops than the "
            "defaulted flags — the off path is not the pre-flag program"))
    for label, pt in (("telemetry", base.replace(telemetry=True)),
                      ("faults", base.replace(faults=(("bank", 0, 2),)))):
        _, on = cycle_ops(engine.params_for(pt), pt)
        if on == off:
            out.append(Finding(
                "carry-flag-leak", f"cycle_batch[{label}-on]",
                f"{label}=True records the off program's ATen ops — the "
                "flag no longer gates any computation"))
    return out


# ------------------------------------------------- pooled serve-step lints
def lint_serve_step(device) -> List[Finding]:
    """The pooled decode step (reduced qwen2.5-3b, page 4, 2 sequences):
    its cache is a fixed point of the step in each variant, and the
    telemetry-on, uncoded and ``recode_budget=-1`` steps each record
    another op sequence than the baseline step's."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.obs.serve import init_serve_telemetry
    from repro_torch.runtime import kvbank as kb
    from repro_torch.runtime.steps import make_pooled_serve_step

    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), kv_page=4)
    kvcfg = kb.KVBankConfig(n_banks=cfg.kv_banks, page=4,
                            pool_pages=4 * cfg.kv_banks, max_pages=4)
    b = 2
    params = lm.init_params(cfg, device=device, max_seq=16)
    token = torch.arange(b, dtype=torch.int64, device=device)

    def cache(coded=True, tele=False):
        pool = kb.pool_init(kvcfg, cfg.n_layers, b, cfg.n_kv, cfg.head_dim,
                            getattr(torch, cfg.compute_dtype), device=device,
                            coded=coded)
        pool.page_table.copy_(torch.arange(
            b * kvcfg.max_pages, dtype=torch.int32,
            device=device).view(b, kvcfg.max_pages))
        pool.length.fill_(3)
        return {"pool": pool, "tele": init_serve_telemetry(
            kvcfg.n_banks, device) if tele else None}

    step = make_pooled_serve_step(cfg, kvcfg)
    variants = {
        "off": (step, dict()),
        "tele-on": (step, dict(tele=True)),
        "uncoded": (step, dict(coded=False)),
        "no-recode": (make_pooled_serve_step(cfg, kvcfg, recode_budget=-1),
                      dict()),
    }
    out: List[Finding] = []
    ops: Dict[str, List[str]] = {}
    for label, (fn, kw) in variants.items():
        out += lint_carry(f"pooled_serve_step[{label}]",
                          lambda c, _fn=fn: _fn(params, token, c)[1],
                          cache(**kw), pick=lambda o: o)
        ops[label] = op_sequence(fn, params, token, cache(**kw))
    for label, why in (
            ("tele-on", "the serve planes no longer measure anything"),
            ("uncoded", "the coded/uncoded pool switch no longer selects "
                        "another program"),
            ("no-recode", "recode_budget=-1 no longer disables the ReCoding "
                          "unit")):
        if ops[label] == ops["off"]:
            out.append(Finding(
                "carry-flag-leak", f"pooled_serve_step[{label}]",
                f"records the baseline step's ATen ops — {why}"))
    return out


# ------------------------------------------------------------- layer entry
def run(strict: bool = False, device=None,
        points: Optional[Sequence] = None) -> List[Finding]:
    """The layer on ``device`` (the card unless named; no card raises)."""
    from repro_torch.kernels.common import resolve_device

    del strict
    dev = resolve_device(device)
    pts = list(points) if points is not None else default_lint_points()
    out = lint_signature_classes(pts, dev)
    out += lint_carry_stability(dev)
    out += lint_flag_identity(dev)
    out += lint_serve_step(dev)
    return out
