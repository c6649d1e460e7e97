"""Plain PyTorch versions of the coded KV decode datapath: the CPU path of
the ``ops`` wrappers and the card-side yardsticks of the CUDA kernels.

* ``gather_pool_plain``: the serving pool gather (same function as
  ``repro/kernels/coded_kv_decode/ops.py:83-100``);
* ``decode_attention_plain``: decode attention over the logical K/V;
* ``coded_kv_decode_plain``: decode attention over per-sequence coded
  banks, the function of ``csrc/coded_kv_decode.cu``."""
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


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, seq_len: torch.Tensor
                           ) -> torch.Tensor:
    """Masked GQA decode attention over the logical K/V (the port of
    ``repro/kernels/coded_kv_decode/ref.py:11``): q (B, H, D), k/v
    (B, T, Hkv, D), seq_len (B,) -> (B, H, D) in q's dtype. Computed in
    f32; head ``h`` reads kv head ``h % Hkv``; keys at index >= seq_len
    are masked, and a sequence with no key reads exact zeros."""
    b, h, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, h // hkv, hkv, d)
    logits = torch.einsum("bgkd,btkd->bgkt", qf, k.float()) * (d ** -0.5)
    mask = (torch.arange(k.shape[1], device=q.device)[None, None, None, :]
            < seq_len.to(q.device)[:, None, None, None])
    logits = torch.where(mask, logits, float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bgkt,btkd->bgkd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def coded_kv_decode_plain(q: torch.Tensor, k_banks: torch.Tensor,
                          v_banks: torch.Tensor, k_par: torch.Tensor,
                          v_par: torch.Tensor, use_parity: torch.Tensor,
                          seq_len: torch.Tensor,
                          value_dtype: torch.dtype) -> torch.Tensor:
    """Decode attention read straight from per-sequence coded banks, as
    ``_kv_decode_kernel`` (``repro/kernels/coded_kv_decode/kernel.py:40``)
    computes it: page ``t < n_pages = use_parity.shape[1]`` is read from
    bank ``t % NB``, slot ``t // NB``; where ``use_parity[b, t]`` is set it
    is ``banks[bank ^ 1, slot] ^ par[bank // 2, slot]`` whether or not that
    parity is right. The lanes are bit-cast to ``value_dtype``.

    q (B, H, D); banks (B, NB, S, P, Hkv, D) integer lanes; parity
    (B, NB/2, S, P, Hkv, D); use_parity (B, n_pages); seq_len (B,)."""
    b, nb, _, page, hkv, d = k_banks.shape
    n_pages = use_parity.shape[1]
    t = torch.arange(n_pages, device=k_banks.device)
    bank, slot = t % nb, t // nb
    deg = use_parity.to(k_banks.device).bool()[..., None, None, None]

    def logical(banks, par):
        pages = torch.where(deg, banks[:, bank ^ 1, slot]
                            ^ par[:, bank // 2, slot], banks[:, bank, slot])
        return pages.reshape(b, n_pages * page, hkv, d).view(value_dtype)

    return decode_attention_plain(q, logical(k_banks, k_par),
                                  logical(v_banks, v_par), seq_len)
