"""Runtime recompile guard: assert a code region compiled nothing new.

The counterpart of the JAX package's ``repro.analysis.guard``, with the
same surface. There a compile is a new program in a jitted entry point's
cache; in the port it is a kernel build: a ``kernels.build.build`` call
that ran ``nvcc`` (``build.COMPILES``, per library). The build is keyed
on a hash of the sources and flags, so an unchanged checkout builds each
library once; a source edited mid-run, a digest that depends on something
unstable, or a path that drops the loaded libraries would rebuild inside a
timed phase, and this guard fails such a region:

    with recompile_guard() as g:           # every GUARDED target
        run_points(grid(base, r=(0.05, 0.1)), device="cuda")
    assert g.compiles() == 0               # the kernels were built before

    with recompile_guard("kernels.xor_encode", max_compiles=1):
        encode_parities(...)               # may build xor_encode once

Budgets are *upper bounds* checked at context exit (``max_compiles=None``
disables the check and just records); exact counts come from
``g.compiles()`` (distinct libraries built) and ``g.deltas()`` (builds
per target). Library loads (``build.LOADS``) are recorded beside them,
``g.loads()``, and never budgeted: a load is no compile.

Targets are *named* as in the JAX package. ``GUARDED`` maps each name to
the libraries whose builds it counts: a kernel's own library, and for
``sweep`` and ``stream`` the two simulator kernels' libraries, the
kernels those entry points launch. The port captures no CUDA graph yet;
when a later change adds graphs, their captures join ``GUARDED`` as
targets of their own.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

from repro_torch.kernels import build

GUARDED: Dict[str, Tuple[str, ...]] = {
    "sweep": ("xor_gather", "xor_encode"),
    "stream": ("xor_gather", "xor_encode"),
    "kernels.xor_encode": ("xor_encode",),
    "kernels.xor_gather": ("xor_gather",),
    "kernels.coded_kv_decode": ("coded_kv_decode",),
    "kernels.pool_gather": ("gather_pool",),
}


def resolve(target: str) -> Tuple[str, ...]:
    """The libraries (``csrc/<name>.cu``) whose builds ``target`` counts."""
    try:
        return GUARDED[target]
    except KeyError:
        raise KeyError(f"unknown guarded entry point {target!r}; "
                       f"have {sorted(GUARDED)}") from None


def cache_size(target: str) -> Optional[int]:
    """Kernel builds (``nvcc`` runs) of ``target``'s libraries so far in
    this process."""
    return sum(build.COMPILES.get(lib, 0) for lib in resolve(target))


def available(target: str = "sweep") -> bool:
    """Whether ``target`` can be guarded: the build counter is the port's
    own, so always, for a known target."""
    return cache_size(target) is not None


class RecompileError(AssertionError):
    """A guarded region compiled more programs than it budgeted for."""


class GuardRecord:
    """Per-target compile deltas of one guarded region (filled on exit;
    ``compiles()`` may also be read mid-region)."""

    def __init__(self, targets: List[Tuple[str, Tuple[str, ...], int]]):
        self._targets = targets
        self._libs = sorted({lib for _, libs, _ in targets for lib in libs})
        self._before = {lib: (build.COMPILES.get(lib, 0),
                              build.LOADS.get(lib, 0)) for lib in self._libs}

    def deltas(self) -> Dict[str, int]:
        """Builds since entry, per target."""
        return {name: cache_size(name) - before
                for name, _, before in self._targets}

    def built(self) -> Dict[str, int]:
        """Builds since entry, per library (each counted once, however
        many targets name it)."""
        return {lib: build.COMPILES.get(lib, 0) - b
                for lib, (b, _) in self._before.items()}

    def compiles(self) -> int:
        """Kernel builds since entry over the guarded libraries."""
        return sum(self.built().values())

    def loads(self) -> Dict[str, int]:
        """Library loads since entry, per library (recorded, not
        budgeted)."""
        return {lib: build.LOADS.get(lib, 0) - b
                for lib, (_, b) in self._before.items()}


@contextlib.contextmanager
def recompile_guard(*targets: str, max_compiles: Optional[int] = 0):
    """Fail (``RecompileError``) if the region builds more than
    ``max_compiles`` kernel libraries across ``targets`` (default: none —
    every kernel must have been built before). Targets are ``GUARDED``
    names; no targets means all of them."""
    names = list(targets) if targets else sorted(GUARDED)
    rec = GuardRecord([(t, resolve(t), cache_size(t)) for t in names])
    yield rec
    if max_compiles is not None:
        total = rec.compiles()
        if total > max_compiles:
            grown = {k: v for k, v in rec.built().items() if v}
            raise RecompileError(
                f"guarded region built {total} kernel librar"
                f"{'y' if total == 1 else 'ies'} (budget {max_compiles}): "
                f"{grown} — a source or the build digest changed inside "
                "the region (kernels.build)")
