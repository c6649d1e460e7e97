"""Plain PyTorch version of the pool gather: the CPU path of
``ops.gather_pool_layer`` and the card-side yardstick of the CUDA kernel
(same function as ``repro/kernels/coded_kv_decode/ops.py:83-100``)."""
from __future__ import annotations

from typing import Tuple

import torch


def gather_pool_plain(
    k_banks: torch.Tensor,     # (NB, S, P, Hkv, D) integer lanes
    v_banks: torch.Tensor,
    k_par: torch.Tensor,       # (NG, S, P, Hkv, D); NG == 0 => uncoded
    v_par: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) physical page id, -1 free
    use_parity: torch.Tensor,  # (B, MP) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, MP, P, Hkv, D) K and V lanes: per logical page the direct read
    ``banks[bank, slot]`` or, where ``use_parity``, the degraded read
    ``banks[bank ^ 1, slot] ^ par[bank // 2, slot]``; holes read zero."""
    nb = k_banks.shape[0]
    phys = page_table.long().clamp(min=0)
    bank = phys % nb
    slot = phys // nb
    alloc = (page_table >= 0)[..., None, None, None]
    up = use_parity.bool()[..., None, None, None]

    def one(banks, par):
        out = banks[bank, slot]
        if par.shape[0] > 0:
            deg = banks[bank ^ 1, slot] ^ par[bank // 2, slot]
            out = torch.where(up, deg, out)
        return torch.where(alloc, out, torch.zeros((), dtype=out.dtype,
                                                   device=out.device))

    return one(k_banks, k_par), one(v_banks, v_par)
