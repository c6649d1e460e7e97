"""Mamba2 SSD (state-space duality) block (``repro.models.ssm``
counterpart, arXiv:2405.21060).

Chunked form (prefill and training): within a chunk the recurrence is
materialized as a masked (semiseparable) attention-like product; across
chunks a short host loop carries the (H, N, P) state. The block is out
of place, so autograd can differentiate it under per-layer recompute.
Decode carries ``SSMCache`` (the conv tail and the f32 (H, P, N) state)
and is O(1) per token; ``ssm_decode`` updates both IN PLACE.

The dtypes follow the JAX package's op by op: the params arrive in the
compute dtype (``A_log``, ``D`` and ``dt_bias`` too, as JAX casts every
float leaf before the block), so ``exp(A_log)`` runs in that dtype, and
the products with the f32 step sizes promote to f32 where JAX's do.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import causal_conv, normal_init

Params = Dict[str, torch.Tensor]


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (..., B, K-1, di + 2N) compute dtype
    state: torch.Tensor  # (..., B, H, P, N) f32


def ssm_dims(cfg: ModelConfig):
    """(d_inner, heads, head dim, state size)."""
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_headdim
    return di, nh, cfg.ssm_headdim, cfg.ssm_state


def ssm_init(cfg: ModelConfig, gen: torch.Generator, dtype,
             lead=()) -> Params:
    """JAX's leaves (``ssm.py:31``), every one in ``dtype`` (JAX's f32
    ``A_log``/``D``/``dt_bias`` values, 0, 1 and 0, are exact in any
    float dtype); ``lead`` prefixes every shape (a layer axis)."""
    d = cfg.d_model
    di, nh, hp, n = ssm_dims(cfg)
    dev = gen.device
    proj_out = 2 * di + 2 * n + nh  # z, x, B, C, dt

    def full(shape, v):
        return torch.full((*lead, *shape), v, dtype=dtype, device=dev)

    return {
        "in_proj": normal_init(gen, (d, proj_out), d ** -0.5, dtype, lead),
        "conv_w": normal_init(gen, (cfg.ssm_conv, di + 2 * n), 0.1, dtype,
                              lead),
        "conv_b": full((di + 2 * n,), 0.0),
        "A_log": full((nh,), 0.0),
        "D": full((nh,), 1.0),
        "dt_bias": full((nh,), 0.0),
        "norm_scale": full((di,), 1.0),
        "out_proj": normal_init(gen, (di, d), di ** -0.5, dtype, lead),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """(z, xBC, dt) of the input projection."""
    di, nh, hp, n = ssm_dims(cfg)
    return torch.split(proj, [di, di + 2 * n, nh], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, then SiLU. xbc (B,T,C), w (K,C)."""
    return F.silu(causal_conv(xbc, w, b))


def _ssd_chunked(u, la, Bm, Cm, chunk: int):
    """u (B,T,H,P) inputs; la (B,T,H) log-decay <= 0; Bm/Cm (B,T,N).

    Returns y (B,T,H,P) f32 and the final state (B,H,P,N) f32."""
    b, t, h, p = u.shape
    n = Bm.shape[-1]
    q = min(chunk, t)
    if t % q:
        raise ValueError(f"ssd: {t} positions are not a multiple of the "
                         f"chunk {q}")
    nc = t // q
    u = u.reshape(b, nc, q, h, p).float()
    la = la.reshape(b, nc, q, h).float()
    Bm = Bm.reshape(b, nc, q, n).float()
    Cm = Cm.reshape(b, nc, q, n).float()
    cum = torch.cumsum(la, dim=2)                           # (B,nc,Q,H)
    total = cum[:, :, -1]                                   # (B,nc,H)

    # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) (C_i.B_j) u_j.
    # Above the diagonal the exponent is >= 0 and exp may overflow: the
    # exponent is masked to -inf there first, so the decay is 0 (what
    # JAX's select after the product gives) and no inf reaches the
    # backward pass, where 0 * inf would make the gradients NaN
    cb = torch.einsum("bcin,bcjn->bcij", Cm, Bm)            # (B,nc,Q,Q)
    tri = torch.ones(q, q, dtype=torch.bool, device=u.device).tril()
    expo = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,Q,H)
    dec = torch.exp(expo.masked_fill(~tri[None, None, :, :, None],
                                     float("-inf")))
    del expo
    w = cb[..., None] * dec
    del dec
    y = torch.einsum("bcijh,bcjhp->bcihp", w, u)
    del w

    # chunk state contribution: S_c = sum_j exp(total - cum_j) B_j u_j^T
    sdec = torch.exp(total[:, :, None, :] - cum)            # (B,nc,Q,H)
    s_c = torch.einsum("bcjn,bcjhp->bchnp", Bm, sdec[..., None] * u)

    # scan chunk states on the host: S_c = exp(total_c) S_{c-1} + S_c
    s = torch.zeros(b, h, n, p, dtype=torch.float32, device=u.device)
    prevs = []
    for c in range(nc):
        prevs.append(s)
        s = torch.exp(total[:, c])[..., None, None] * s + s_c[:, c]
    s_prevs = torch.stack(prevs, 1)                         # (B,nc,H,N,P)

    # inter-chunk: y_i += exp(cum_i) C_i . S_prev
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "bcin,bchnp->bcihp", Cm, s_prevs)
    return y.reshape(b, t, h, p), s.transpose(-1, -2)       # (B,H,P,N)


def _gated_out(p: Params, y: torch.Tensor, z: torch.Tensor,
               dtype) -> torch.Tensor:
    """Gated RMS norm (mamba2) and the output projection; y f32."""
    y = y.to(dtype) * F.silu(z)
    yf = y.float()
    ms = yf.square().mean(-1, keepdim=True)
    y = (yf * torch.rsqrt(ms + 1e-6)).to(dtype) * p["norm_scale"]
    return y @ p["out_proj"]


def ssm_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
              chunk: int = 128, return_cache: bool = False):
    """Full-sequence SSD block (prefill). x (B,T,D) -> (B,T,D), and with
    ``return_cache`` the ``SSMCache`` a decode continues from."""
    di, nh, hp, n = ssm_dims(cfg)
    b, t, _ = x.shape
    z, xbc_raw, dt = _split_proj(cfg, x @ p["in_proj"])
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xi, Bm, Cm = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])              # (B,T,H) f32
    a = -torch.exp(p["A_log"])                              # (H,) its dtype
    la = dt * a[None, None, :]
    xh = xi.reshape(b, t, nh, hp).float()
    y, s_final = _ssd_chunked(xh * dt[..., None], la, Bm, Cm, chunk)
    y = y + p["D"][None, None, :, None] * xh
    out = _gated_out(p, y.reshape(b, t, di), z, x.dtype)
    if not return_cache:
        return out
    k = cfg.ssm_conv
    tail = xbc_raw[:, t - (k - 1):] if t >= k - 1 else F.pad(
        xbc_raw, (0, 0, k - 1 - t, 0))
    return out, SSMCache(conv=tail, state=s_final)


def ssm_cache_init(cfg: ModelConfig, batch: int, dtype, device,
                   lead=()) -> SSMCache:
    """An empty cache; ``lead`` prefixes both shapes (a layer axis)."""
    di, nh, hp, n = ssm_dims(cfg)
    return SSMCache(
        conv=torch.zeros(*lead, batch, cfg.ssm_conv - 1, di + 2 * n,
                         dtype=dtype, device=device),
        state=torch.zeros(*lead, batch, nh, hp, n, dtype=torch.float32,
                          device=device))


def ssm_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
               cache: SSMCache):
    """One-token step. x (B,1,D) -> (out (B,1,D), cache), the cache's conv
    tail and state updated IN PLACE."""
    di, nh, hp, n = ssm_dims(cfg)
    z, xbc, dt = _split_proj(cfg, x[:, 0] @ p["in_proj"])
    hist = torch.cat([cache.conv, xbc[:, None]], 1)          # (B,K,C)
    conv = torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"]
    xi, Bm, Cm = torch.split(F.silu(conv), [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])              # (B,H)
    a = torch.exp(dt * -torch.exp(p["A_log"]))              # (B,H)
    xh = xi.reshape(-1, nh, hp).float()
    u = xh * dt[..., None]
    state = cache.state
    state.mul_(a[..., None, None]).add_(
        u[..., None] * Bm.float()[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", state, Cm.float())
    y = y + p["D"][None, :, None] * xh
    out = _gated_out(p, y.reshape(-1, di), z, x.dtype)[:, None]
    cache.conv.copy_(hist[:, 1:])
    return out, cache
