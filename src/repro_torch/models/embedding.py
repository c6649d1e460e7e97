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

from repro_torch.axes import from_local, is_dtensor, sharded
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
                  par: Optional[torch.Tensor],
                  lo: Optional[int] = None) -> torch.Tensor:
    """The coded gather; with ``lo``, ``banks`` (and ``par``) hold bank
    rows ``lo`` on (a model rank's shard) and a token whose row lies
    elsewhere reads -0.0, which leaves the sum over the shards exact."""
    nb = banks.shape[0]
    u = as_lanes(banks)
    if par is None:
        par = coded_parity(banks)
    bank_of = tokens % nb
    brow = tokens // nb
    use_par = _plan_use_parity(bank_of, nb)
    if lo is not None:
        brow = brow - lo
        owned = (brow >= 0) & (brow < banks.shape[1])
        brow = brow.clamp(0, banks.shape[1] - 1)
    direct = u[bank_of, brow]
    degraded = u[bank_of ^ 1, brow] ^ par[bank_of // 2, brow]
    out = torch.where(use_par[..., None], degraded, direct).view(banks.dtype)
    if lo is None:
        return out
    return out.masked_fill(~owned[..., None], -0.0)


class CodedLookup(torch.autograd.Function):
    """``repro`` embedding.py:68-91. Forward: the coded gather, degraded
    reads included. Backward: ``g`` scatter-added into a zero (NB, Vb, D)
    at (token % NB, token // NB) in the banks' dtype (duplicate tokens
    accumulate in that dtype, as JAX's ``.at[].add`` does); no gradient
    to the tokens or the parity."""

    @staticmethod
    def forward(ctx, banks, tokens, par, lo=None):
        ctx.save_for_backward(tokens)
        ctx.bank_shape, ctx.bank_dtype, ctx.lo = banks.shape, banks.dtype, lo
        return _coded_gather(banks, tokens, par, lo)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        nb, vb = ctx.bank_shape[:2]
        d_banks = g.new_zeros(ctx.bank_shape, dtype=ctx.bank_dtype)
        g = g.to(ctx.bank_dtype)
        brow = tokens // nb
        if ctx.lo is not None:     # a shard: the other rows' adds are -0.0
            brow = brow - ctx.lo
            owned = (brow >= 0) & (brow < vb)
            brow = brow.clamp(0, vb - 1)
            g = g.masked_fill(~owned[..., None], -0.0)
        d_banks.index_put_((tokens % nb, brow), g, accumulate=True)
        return d_banks, None, None, None


def coded_lookup(banks: torch.Tensor, tokens: torch.Tensor,
                 par: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coded-bank gather of ``tokens`` (..., T) -> (..., T, D) in
    ``banks.dtype``, differentiable in ``banks``. ``par`` is
    ``coded_parity(banks)`` when the caller keeps it; otherwise it is
    computed here."""
    return CodedLookup.apply(banks, tokens.long(), par, None)


def embed_lookup(cfg: ModelConfig, p: Params, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    key = "banks" if cfg.coded_embedding else "table"
    if is_dtensor(p[key]):
        return _sharded_lookup(cfg, p, key, tokens).to(dtype)
    if cfg.coded_embedding:
        return coded_lookup(p["banks"], tokens, p.get("par")).to(dtype)
    return p["table"][tokens.long()].to(dtype)


def _sharded_lookup(cfg: ModelConfig, p: Params, key: str, tokens):
    """The lookup on a DTensor table whose vocab rows shard over mesh
    dims (``launch.sharding``: ``model``): each rank gathers the rows it
    holds from its local shard, -0.0 for the others, and the result is
    ``Partial`` over those dims, so the ``shard`` pin after the embedding
    all-reduces it. The table is never all-gathered. ``tokens`` is a
    DTensor (batch-sharded) or a plain tensor (replicated). The table's
    local gradient is partial over the mesh dims that shard the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    w = p[key]
    mesh = w.device_mesh
    row = 1 if key == "banks" else 0
    tok_pl = tokens.placements if is_dtensor(tokens) \
        else (Replicate(),) * mesh.ndim
    ltok = (tokens.to_local() if is_dtensor(tokens) else tokens).long()
    out_pl, grad_pl, lo = [], [], 0
    for dim, (wp, tp) in enumerate(zip(w.placements, tok_pl)):
        if isinstance(tp, Shard):
            out_pl.append(Shard(tp.dim))
        elif isinstance(wp, Shard) and wp.dim == row:
            out_pl.append(Partial())
        else:
            out_pl.append(Replicate())
        if isinstance(wp, Shard):
            if wp.dim != row:
                raise ValueError(f"embedding {key}: placements "
                                 f"{w.placements} shard a non-vocab dim")
            grad_pl.append(wp)
            lo = lo * mesh.size(dim) + mesh.get_local_rank(dim)
        else:
            grad_pl.append(Partial() if isinstance(tp, Shard)
                           else Replicate())
    local = w.to_local(grad_placements=grad_pl)
    n_rows = local.shape[row]
    if key == "banks":
        par = p.get("par")
        if par is not None:
            par = par.to_local()
        out = CodedLookup.apply(local, ltok, par, lo * n_rows)
    else:
        r = ltok - lo * n_rows
        owned = (r >= 0) & (r < n_rows)
        out = local[r.clamp(0, n_rows - 1)].masked_fill(~owned[..., None],
                                                        -0.0)
    return from_local(out, mesh, out_pl, (*tokens.shape, out.shape[-1]))


def full_table(cfg: ModelConfig, p: Params) -> torch.Tensor:
    """The (V_pad, D) logical table (a copy for the coded layout)."""
    if not cfg.coded_embedding:
        return p["table"]
    nb, vb, d = p["banks"].shape
    return p["banks"].transpose(0, 1).reshape(nb * vb, d)[: cfg.vocab_pad]


def tied_logits(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ full_table(p).T`` (..., T, V_pad) in ``x``'s dtype, computed on
    the bank layout without assembling the logical table: bank ``n``'s
    product gives the logits of rows ``v = r * NB + n``. On DTensor banks
    (bank rows sharded) the logical table's rows are sharded in the same
    order, so the product through it keeps the logits vocab-sharded."""
    if not cfg.coded_embedding:
        return x @ p["table"].to(x.dtype).T
    if is_dtensor(p["banks"]) and sharded(p["banks"], 1):
        # the vocab-sharded logical table
        return x @ full_table(cfg, p).to(x.dtype).T
    banks = p["banks"].to(x.dtype)
    nb, vb, d = banks.shape
    rows = x.reshape(1, -1, d)                        # each bank read once
    per_bank = rows @ banks.transpose(1, 2)           # (NB, N, Vb)
    logits = per_bank.permute(1, 2, 0).reshape(*x.shape[:-1], vb * nb)
    return logits[..., : cfg.vocab_pad]
