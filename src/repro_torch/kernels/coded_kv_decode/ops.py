"""Public wrappers of the coded KV decode datapath (``repro`` counterpart:
``kernels/coded_kv_decode/ops.py``): ``pack_kv_banks`` packs a logical KV
cache into per-sequence coded banks, ``coded_kv_decode`` is decode
attention over them, ``gather_pool_layer`` is the serving pool gather and
``coded_kv_decode_pool`` decode attention over the serving pool.

Dispatch is by the tensors' device, with no switch and no fallback: CUDA
tensors go through the hand-written kernel (which launches or raises), CPU
tensors through the plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.coded_kv_decode.kernel import (coded_kv_decode_cuda,
                                                        gather_pool_cuda)
from repro_torch.kernels.coded_kv_decode.ref import (coded_kv_decode_plain,
                                                     decode_attention_plain,
                                                     gather_pool_plain)
from repro_torch.kernels.common import as_lanes


def pack_kv_banks(
    k: torch.Tensor,           # (B, T, Hkv, D)
    v: torch.Tensor,
    n_banks: int,
    page: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Stripe KV pages over ``n_banks`` banks plus pairwise XOR parity
    banks: page ``t`` lives in bank ``t % n_banks``, slot ``t // n_banks``;
    parity group ``g`` holds ``bank[2g] ^ bank[2g+1]``. Returns the lanes
    (k_banks, v_banks (B, NB, S, page, Hkv, D); k_par, v_par (B, NB/2, S,
    page, Hkv, D)) and the page count. T must be a multiple of
    ``n_banks * page``."""
    if n_banks % 2:
        raise ValueError(f"pairwise parity needs an even bank count, got "
                         f"{n_banks}")
    b, t, hkv, d = k.shape
    if t % (n_banks * page):
        raise ValueError(f"T={t} is not a multiple of {n_banks} banks x "
                         f"{page}-token pages")
    n_pages = t // page
    slots = n_pages // n_banks

    def banks(x):
        x = as_lanes(x) if x.dtype.is_floating_point else x
        return x.reshape(b, slots, n_banks, page, hkv, d) \
            .transpose(1, 2).contiguous()

    ku, vu = banks(k), banks(v)
    return ku, vu, ku[:, 0::2] ^ ku[:, 1::2], vu[:, 0::2] ^ vu[:, 1::2], \
        n_pages


def coded_kv_decode(
    q: torch.Tensor,           # (B, H, D)
    k_banks: torch.Tensor,     # (B, NB, S, P, Hkv, D) integer lanes
    v_banks: torch.Tensor,
    k_par: torch.Tensor,       # (B, NB/2, S, P, Hkv, D)
    v_par: torch.Tensor,
    use_parity: torch.Tensor,  # (B, n_pages) bool/int
    seq_len: torch.Tensor,     # (B,)
    *,
    value_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Decode attention over the coded banked KV cache (one new token):
    (B, H, D) in q's dtype. ``value_dtype`` (default q's) is the type the
    lanes hold."""
    if value_dtype is None:
        value_dtype = q.dtype
    use_parity = use_parity.to(torch.int32).contiguous()
    seq_len = seq_len.to(torch.int32).contiguous()
    dev = k_banks.device.type
    if dev == "cuda":
        return coded_kv_decode_cuda(q, k_banks, v_banks, k_par, v_par,
                                    use_parity, seq_len, value_dtype)
    if dev == "cpu":
        return coded_kv_decode_plain(q, k_banks, v_banks, k_par, v_par,
                                     use_parity, seq_len, value_dtype)
    raise ValueError(f"coded_kv_decode: no datapath for device {dev}")


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


def coded_kv_decode_pool(
    q: torch.Tensor,           # (B, H, D)
    k_banks: torch.Tensor,     # (NB, S, P, Hkv, D) integer lanes
    v_banks: torch.Tensor,
    k_par: torch.Tensor,       # (NG, S, P, Hkv, D); NG == 0 => uncoded
    v_par: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP)
    use_parity: torch.Tensor,  # (B, MP) bool
    seq_len: torch.Tensor,     # (B,)
    *,
    value_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Decode attention over the serving pool layout (shared page table,
    one layer's banks): the pool gather, then decode attention over the
    logical K/V."""
    if value_dtype is None:
        value_dtype = q.dtype
    k, v = gather_pool_layer(k_banks, v_banks, k_par, v_par, page_table,
                             use_parity.bool(), value_dtype)
    return decode_attention_plain(q, k, v, seq_len.to(torch.int32))
