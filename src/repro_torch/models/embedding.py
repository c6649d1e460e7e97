"""Vocab embeddings — plain table or the paper's coded banks
(``repro.models.embedding`` counterpart).

Coded layout: row ``v`` lives in bank ``v % NB``, bank row ``v // NB``;
bank pairs ``(2g, 2g+1)`` carry an XOR parity bank. Within each sequence
every second lookup that lands on a bank is served as a degraded read
(pair sibling ^ parity), bit-exact. Training differentiates the lookup
through ``CodedLookup`` (JAX's ``custom_vjp``): the forward runs the coded
datapath, the backward is the plain scatter-add into the bank layout.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import as_lanes
from repro_torch.models.layers import normal_init

Params = Dict[str, torch.Tensor]


def embed_init(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    """The table (V_pad, D), or the coded banks (NB, V_pad / NB, D) drawn
    one bank at a time, in ``dtype``."""
    v, d = cfg.vocab_pad, cfg.d_model
    if not cfg.coded_embedding:
        return {"table": normal_init(gen, (v, d), d ** -0.5, dtype)}
    nb = cfg.embed_banks
    return {"banks": normal_init(gen, (-(-v // nb), d), d ** -0.5, dtype,
                                 (nb,))}


def coded_parity(banks: torch.Tensor) -> torch.Tensor:
    """(NB/2, Vb, D) parity lanes of the bank pairs."""
    u = as_lanes(banks)
    return u[0::2] ^ u[1::2]


def _plan_use_parity(bank_of: torch.Tensor, nb: int) -> torch.Tensor:
    """Odd-ranked lookups of each bank go degraded; ranks count along the
    last (sequence) axis only, so the plan is batch-parallel."""
    oh = F.one_hot(bank_of, nb)                         # (..., T, NB)
    rank = torch.cumsum(oh, dim=-2) - oh                # occurrences before t
    my_rank = torch.gather(rank, -1, bank_of[..., None])[..., 0]
    return (my_rank % 2) == 1


def _coded_gather(banks: torch.Tensor, tokens: torch.Tensor,
                  par: Optional[torch.Tensor]) -> torch.Tensor:
    nb = banks.shape[0]
    u = as_lanes(banks)
    if par is None:
        par = coded_parity(banks)
    bank_of = tokens % nb
    brow = tokens // nb
    use_par = _plan_use_parity(bank_of, nb)
    direct = u[bank_of, brow]
    degraded = u[bank_of ^ 1, brow] ^ par[bank_of // 2, brow]
    return torch.where(use_par[..., None], degraded, direct).view(banks.dtype)


class CodedLookup(torch.autograd.Function):
    """``repro`` embedding.py:68-91. Forward: the coded gather, degraded
    reads included. Backward: ``g`` scatter-added into a zero (NB, Vb, D)
    at (token % NB, token // NB) in the banks' dtype (duplicate tokens
    accumulate in that dtype, as JAX's ``.at[].add`` does); no gradient
    to the tokens or the parity."""

    @staticmethod
    def forward(ctx, banks, tokens, par):
        ctx.save_for_backward(tokens)
        ctx.bank_shape, ctx.bank_dtype = banks.shape, banks.dtype
        return _coded_gather(banks, tokens, par)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        nb = ctx.bank_shape[0]
        d_banks = g.new_zeros(ctx.bank_shape, dtype=ctx.bank_dtype)
        d_banks.index_put_((tokens % nb, tokens // nb),
                           g.to(ctx.bank_dtype), accumulate=True)
        return d_banks, None, None


def coded_lookup(banks: torch.Tensor, tokens: torch.Tensor,
                 par: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coded-bank gather of ``tokens`` (..., T) -> (..., T, D) in
    ``banks.dtype``, differentiable in ``banks``. ``par`` is
    ``coded_parity(banks)`` when the caller keeps it; otherwise it is
    computed here."""
    return CodedLookup.apply(banks, tokens.long(), par)


def embed_lookup(cfg: ModelConfig, p: Params, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    if cfg.coded_embedding:
        return coded_lookup(p["banks"], tokens, p.get("par")).to(dtype)
    return p["table"][tokens.long()].to(dtype)


def full_table(cfg: ModelConfig, p: Params) -> torch.Tensor:
    """The (V_pad, D) logical table (a copy for the coded layout)."""
    if not cfg.coded_embedding:
        return p["table"]
    nb, vb, d = p["banks"].shape
    return p["banks"].transpose(0, 1).reshape(nb * vb, d)[: cfg.vocab_pad]


def tied_logits(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ full_table(p).T`` (..., T, V_pad) in ``x``'s dtype, computed on
    the bank layout without assembling the logical table: bank ``n``'s
    product gives the logits of rows ``v = r * NB + n``."""
    if not cfg.coded_embedding:
        return x @ p["table"].to(x.dtype).T
    banks = p["banks"].to(x.dtype)
    nb, vb, d = banks.shape
    rows = x.reshape(1, -1, d)                        # each bank read once
    per_bank = rows @ banks.transpose(1, 2)           # (NB, N, Vb)
    logits = per_bank.permute(1, 2, 0).reshape(*x.shape[:-1], vb * nb)
    return logits[..., : cfg.vocab_pad]
