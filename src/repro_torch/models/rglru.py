"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427;
``repro.models.rglru`` counterpart).

Two input projections (the recurrent branch and a GeLU gate branch), a
short causal conv on the recurrent branch, the diagonal gated recurrence

    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t),
    log a_t = -c * softplus(Lambda) * r_t            (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

and an output projection after gating; the gates use block-diagonal
weights. Prefill runs the recurrence as a log-step (Hillis-Steele) scan,
ceil(log2 T) passes of shifted multiply-adds over (a, w): JAX's
``lax.associative_scan`` associates in another order, so the results
agree within float tolerance, not bit for bit. Decode carries
``RGLRUCache`` (the conv tail and the f32 h) and updates it IN PLACE;
the full-sequence block is out of place, so autograd can differentiate
it under per-layer recompute.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import causal_conv, normal_init

Params = Dict[str, torch.Tensor]

_C = 8.0
_N_BLOCKS = 16
_CONV_K = 4


class RGLRUCache(NamedTuple):
    conv: torch.Tensor  # (..., B, K-1, dr) compute dtype
    h: torch.Tensor     # (..., B, dr) f32


def rglru_init(cfg: ModelConfig, gen: torch.Generator, dtype,
               lead=()) -> Params:
    """JAX's leaves (``rglru.py:31``) in ``dtype`` (``lam``'s 0.5 is
    exact in any float dtype); ``lead`` prefixes every shape."""
    d = cfg.d_model
    dr = d  # lru width = d_model (recurrentgemma)
    nb = _N_BLOCKS if dr % _N_BLOCKS == 0 else 1
    bs = dr // nb
    dev = gen.device
    return {
        "w_y": normal_init(gen, (d, dr), d ** -0.5, dtype, lead),
        "w_gate": normal_init(gen, (d, dr), d ** -0.5, dtype, lead),
        "conv_w": normal_init(gen, (_CONV_K, dr), 0.1, dtype, lead),
        "conv_b": torch.zeros(*lead, dr, dtype=dtype, device=dev),
        "wa_blocks": normal_init(gen, (nb, bs, bs), bs ** -0.5, dtype, lead),
        "wx_blocks": normal_init(gen, (nb, bs, bs), bs ** -0.5, dtype, lead),
        "lam": torch.full((*lead, dr), 0.5, dtype=dtype, device=dev),
        "w_out": normal_init(gen, (dr, d), dr ** -0.5, dtype, lead),
    }


def _block_linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block-diagonal linear: w (nb, bs, bs), x (..., nb*bs)."""
    nb, bs, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bs)
    return torch.einsum("...nb,nbc->...nc", xs, w).reshape(x.shape)


def _gates(p: Params, xr: torch.Tensor):
    """(a, w) of the recurrence, f32: ``softplus(lam)`` and its product
    with ``-c`` stay in ``lam``'s dtype, as in the JAX package."""
    r = torch.sigmoid(_block_linear(p["wa_blocks"], xr).float())
    i = torch.sigmoid(_block_linear(p["wx_blocks"], xr).float())
    log_a = -_C * F.softplus(p["lam"]) * r                 # (..., dr) <= 0
    a = torch.exp(log_a)
    w_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, w_in * i * xr.float()


def linear_scan(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + w_t over axis 1 from h_{-1} = 0, as a
    Hillis-Steele scan: after the pass with shift k, (a_t, w_t) hold the
    composition of the 2k steps ending at t (fewer at the start)."""
    k, t = 1, a.shape[1]
    while k < t:
        w = torch.cat([w[:, :k], a[:, k:] * w[:, :-k] + w[:, k:]], 1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], 1)
        k *= 2
    return w


def rglru_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                return_cache: bool = False):
    """Full-sequence recurrent block (prefill). x (B,T,D) -> (B,T,D), and
    with ``return_cache`` the ``RGLRUCache`` a decode continues from.
    ``cfg.rg_scan_bf16`` runs the scan on bf16 (a, w), as JAX does."""
    xr0 = x @ p["w_y"]                                      # raw conv input
    xr = causal_conv(xr0, p["conv_w"], p["conv_b"])         # (B,T,dr)
    a, w = _gates(p, xr)
    if cfg.rg_scan_bf16:
        a, w = a.to(torch.bfloat16), w.to(torch.bfloat16)
    h = linear_scan(a, w)
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    if not return_cache:
        return out
    t = x.shape[1]
    tail = xr0[:, t - (_CONV_K - 1):] if t >= _CONV_K - 1 else F.pad(
        xr0, (0, 0, _CONV_K - 1 - t, 0))
    return out, RGLRUCache(conv=tail, h=h[:, -1].float())


def rglru_cache_init(cfg: ModelConfig, batch: int, dtype, device,
                     lead=()) -> RGLRUCache:
    """An empty cache; ``lead`` prefixes both shapes (a layer axis)."""
    dr = cfg.d_model
    return RGLRUCache(
        conv=torch.zeros(*lead, batch, _CONV_K - 1, dr, dtype=dtype,
                         device=device),
        h=torch.zeros(*lead, batch, dr, dtype=torch.float32, device=device))


def rglru_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 cache: RGLRUCache):
    """One-token step. x (B,1,D) -> (out (B,1,D), cache), the cache's conv
    tail and h updated IN PLACE."""
    xr0 = x[:, 0] @ p["w_y"]                                # (B,dr)
    hist = torch.cat([cache.conv, xr0[:, None]], 1)
    xr = torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"]
    a, w = _gates(p, xr)
    h = cache.h
    h.mul_(a).add_(w)
    gate = F.gelu(x[:, 0] @ p["w_gate"], approximate="tanh")
    out = ((h.to(x.dtype) * gate) @ p["w_out"])[:, None]
    cache.conv.copy_(hist[:, 1:])
    return out, cache
