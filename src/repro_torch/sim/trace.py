"""Synthetic multi-core memory traces with PARSEC-like structure (§V-A),
port of ``repro/sim/trace.py``.

The generators draw from numpy's ``default_rng(seed)`` in the JAX
package's order, so a trace here equals the JAX one bit for bit; only the
container differs (a ``Trace`` of torch tensors on the requested device).

  * ``banded_trace``     — a few persistent address bands (dedup-like);
  * ``split_band_trace`` — the bands split into many narrower ones (Fig 16);
  * ``ramp_trace``       — band centres drift linearly (Fig 17);
  * ``uniform_trace``    — unstructured worst case;
  * ``zipf_trace``       — hot-row skew on a subset of banks.

Addresses are linear; ``bank = addr % n_banks``, ``row = (addr // n_banks)
% n_rows`` (low-bit interleaving).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.system import Trace
from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    n_cores: int = 8
    length: int = 512          # requests per core (incl. idle gaps)
    n_banks: int = 8
    n_rows: int = 512          # rows per bank
    issue_prob: float = 1.0    # request density
    write_frac: float = 0.3
    seed: int = 0


def addr_to_bank_row(addr: np.ndarray, n_banks: int, n_rows: int):
    """Low-bit interleaving: ``bank = addr % n_banks``, ``row = (addr //
    n_banks) % n_rows``."""
    bank = (addr % n_banks).astype(np.int32)
    row = ((addr // n_banks) % n_rows).astype(np.int32)
    return bank, row


def _pack(spec: TraceSpec, addr: np.ndarray, rng: np.random.Generator,
          device) -> Trace:
    """addr (n_cores, T) linear addresses (−1 = idle) → Trace on device."""
    dev = resolve_device(device)
    valid = (addr >= 0) & (rng.random(addr.shape) < spec.issue_prob)
    addr = np.maximum(addr, 0)
    bank, row = addr_to_bank_row(addr, spec.n_banks, spec.n_rows)
    is_write = rng.random(addr.shape) < spec.write_frac
    data = rng.integers(1, 1 << 30, addr.shape).astype(np.int32)
    return Trace(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in (bank, row, is_write & valid, data, valid)))


def _band_walk(spec, centers, width, rng, drift_per_cycle=0.0,
               band_weights=None, strides: Optional[Sequence[int]] = None):
    """Each core walks inside one (weighted-random) band with its stride:
    half the cores sequential, a quarter stride 2, a quarter column walkers
    (stride ``n_banks``, hammering one bank)."""
    n_bands = len(centers)
    space = spec.n_banks * spec.n_rows
    if band_weights is None:
        band_weights = np.ones(n_bands) / n_bands
    if strides is None:
        base = [1, 1, 1, 1, 2, 2, spec.n_banks, spec.n_banks]
        strides = [base[c % len(base)] for c in range(spec.n_cores)]
    addr = np.full((spec.n_cores, spec.length), -1, np.int64)
    for c in range(spec.n_cores):
        stride = int(strides[c])
        band = rng.choice(n_bands, p=band_weights)
        pos = int(centers[band] - width // 2 + rng.integers(0, max(width, 1)))
        for t in range(spec.length):
            # occasional band switch / random jump (locality noise)
            u = rng.random()
            if u < 0.02:
                band = rng.choice(n_bands, p=band_weights)
                pos = int(centers[band] - width // 2
                          + rng.integers(0, max(width, 1)))
            elif u < 0.05:
                pos += int(rng.integers(-8, 9))
            center = centers[band] + drift_per_cycle * t
            lo = int(center - width // 2)
            hi = lo + max(width, 1)
            if pos < lo or pos >= hi:
                pos = lo + (pos - lo) % max(width, 1)
            addr[c, t] = pos % space
            pos += stride
    return addr


def banded_trace(spec: TraceSpec, n_bands: int = 2,
                 band_width: Optional[int] = None, device=None) -> Trace:
    """A few persistent hot bands of sequential addresses (~3% of the
    address space each; two dominant)."""
    rng = np.random.default_rng(spec.seed)
    space = spec.n_banks * spec.n_rows
    if band_width is None:
        band_width = max(space // 32, spec.n_banks * 4)
    centers = (np.arange(n_bands) + 0.5) * (space / n_bands)
    w = np.ones(n_bands)
    w[: min(2, n_bands)] = 4.0
    w /= w.sum()
    addr = _band_walk(spec, centers.astype(np.int64), band_width, rng, 0.0, w)
    return _pack(spec, addr, rng, device)


def split_band_trace(spec: TraceSpec, n_bands: int = 8,
                     device=None) -> Trace:
    """The primary bands split into many narrower bands."""
    rng = np.random.default_rng(spec.seed)
    space = spec.n_banks * spec.n_rows
    band_width = max(space // (4 * n_bands), spec.n_banks)
    centers = ((np.arange(n_bands) + 0.5) * (space / n_bands)).astype(np.int64)
    addr = _band_walk(spec, centers, band_width, rng)
    return _pack(spec, addr, rng, device)


def ramp_trace(spec: TraceSpec, n_bands: int = 2,
               drift_total: Optional[float] = None, device=None) -> Trace:
    """Band centres ramp linearly across the address space."""
    rng = np.random.default_rng(spec.seed)
    space = spec.n_banks * spec.n_rows
    band_width = max(space // 16, spec.n_banks * 4)
    centers = ((np.arange(n_bands) + 0.5) * (space / n_bands)).astype(np.int64)
    if drift_total is None:
        drift_total = space / 2
    drift = drift_total / max(spec.length, 1)
    addr = _band_walk(spec, centers, band_width, rng, drift_per_cycle=drift)
    return _pack(spec, addr, rng, device)


def uniform_trace(spec: TraceSpec, device=None) -> Trace:
    """Unstructured random accesses (the schemes' worst case)."""
    rng = np.random.default_rng(spec.seed)
    space = spec.n_banks * spec.n_rows
    addr = rng.integers(0, space, (spec.n_cores, spec.length)).astype(np.int64)
    return _pack(spec, addr, rng, device)


def zipf_trace(spec: TraceSpec, a: float = 1.2,
               hot_banks: Sequence[int] = (0, 1), device=None) -> Trace:
    """Zipf-skewed rows concentrated on a subset of banks."""
    rng = np.random.default_rng(spec.seed)
    rows = np.minimum(rng.zipf(a, (spec.n_cores, spec.length)) - 1,
                      spec.n_rows - 1)
    banks = rng.choice(np.asarray(hot_banks), (spec.n_cores, spec.length))
    addr = rows * spec.n_banks + banks
    return _pack(spec, addr.astype(np.int64), rng, device)


TRACES = {
    "banded": banded_trace,
    "split": split_band_trace,
    "ramp": ramp_trace,
    "uniform": uniform_trace,
    "zipf": zipf_trace,
}
