"""Plain PyTorch version of the coded row gather: the CPU path of
``ops.gather_decode`` and the card-side yardstick of the CUDA kernel (the
same function as ``repro/kernels/xor_gather/ref.py::gather_decode_ref``)."""
from __future__ import annotations

import torch

from repro_torch.core.codes import MAX_OPTS
from repro_torch.kernels.common import as_lanes

MODE_REDIRECT = 2 + MAX_OPTS


def gather_decode_plain(banks, parities, bank, row, mode, par, prow, sib0,
                        sib1) -> torch.Tensor:
    """(N, W) lanes: per request ``banks[bank, row]`` (mode 0/1 and any
    mode past REDIRECT), ``parities[par, prow] ^ banks[sib0, row] ^
    banks[sib1, row]`` for a degraded option (mode 2..5; a sibling of -1
    is skipped), ``parities[par, prow]`` for REDIRECT (mode 6), and 0 for
    mode -1. Every index is clamped into range, as JAX's gather clamps it
    (torch would raise instead)."""
    if banks.dtype.is_floating_point:
        banks = as_lanes(banks)
    if parities.dtype.is_floating_point:
        parities = as_lanes(parities)
    if parities.dtype != banks.dtype:
        raise TypeError(f"lane dtype mismatch: {banks.dtype} vs "
                        f"{parities.dtype}")
    nd, rows = banks.shape[:2]
    npar, prows = parities.shape[:2]
    i = row.long().clamp(0, rows - 1)
    direct = banks[bank.long().clamp(0, nd - 1), i]             # (N, W)
    pline = parities[par.long().clamp(0, npar - 1),
                     prow.long().clamp(0, prows - 1)]
    dec = pline
    for s in (sib0, sib1):
        sv = banks[s.long().clamp(0, nd - 1), i]
        dec = dec ^ torch.where((s >= 0)[:, None], sv, 0)
    is_opt = ((mode >= 2) & (mode < MODE_REDIRECT))[:, None]
    val = torch.where((mode == MODE_REDIRECT)[:, None], pline,
                      torch.where(is_opt, dec, direct))
    return torch.where((mode >= 0)[:, None], val, 0)
