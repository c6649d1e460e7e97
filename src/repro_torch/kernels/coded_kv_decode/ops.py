"""Public wrapper of the serving pool gather (``repro`` counterpart:
``kernels/coded_kv_decode/ops.py:46 gather_pool_layer``).

Dispatch is by the tensors' device, with no switch and no fallback: CUDA
tensors go through the hand-written kernel (which launches or raises), CPU
tensors through the plain PyTorch version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.coded_kv_decode.kernel import gather_pool_cuda
from repro_torch.kernels.coded_kv_decode.ref import gather_pool_plain


def gather_pool_layer(
    k_banks: torch.Tensor,     # (NB, S, P, Hkv, D) integer lanes
    v_banks: torch.Tensor,
    k_par: torch.Tensor,       # (NG, S, P, Hkv, D); NG == 0 => uncoded
    v_par: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) int32 physical page id, -1 free
    use_parity: torch.Tensor,  # (B, MP) bool
    value_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's logical (B, MP*P, Hkv, D) K/V in ``value_dtype``, read
    from the pool through the planned mix of direct and degraded (sibling
    ^ parity) reads. Bit-exact reconstruction; holes read as zero."""
    dev = k_banks.device.type
    if dev == "cuda":
        ko, vo = gather_pool_cuda(k_banks, v_banks, k_par, v_par,
                                  page_table, use_parity)
    elif dev == "cpu":
        ko, vo = gather_pool_plain(k_banks, v_banks, k_par, v_par,
                                   page_table, use_parity)
    else:
        raise ValueError(f"gather_pool_layer: no datapath for device {dev}")
    b, mp, pg, hkv, d = ko.shape
    return (ko.reshape(b, mp * pg, hkv, d).view(value_dtype),
            vo.reshape(b, mp * pg, hkv, d).view(value_dtype))
