"""Transformer layers of the serving and training slices
(``repro.models.layers`` counterparts): RMS norm and LayerNorm, half-split
RoPE, GQA attention with optional QKV bias (full-sequence, in query
chunks, and one-token decode over a ring cache; RoPE only where the
config asks for it), the encoder-decoder's cross-attention, the SwiGLU
MLP, the ungated GELU MLP, and the recurrent mixers' short causal conv.
Plain functions over parameter dicts in the JAX package's ``(d_in,
d_out)`` layout, so ``x @ W`` needs no transpose.
Everything but ``attention_decode`` (which writes its caches in place)
is out of place, so autograd can differentiate it."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = Dict[str, torch.Tensor]


def normal_init(gen: torch.Generator, shape, scale: float, dtype,
                lead=()) -> torch.Tensor:
    """``scale`` times standard normals of ``(*lead, *shape)`` in ``dtype``,
    drawn in f32 one leading index (one layer) at a time: the f32
    temporary is one layer's leaf, never the stacked model's."""
    out = torch.empty((*lead, *shape), dtype=dtype, device=gen.device)
    for layer in out.view(-1, *shape):
        layer.copy_(torch.randn(shape, generator=gen, device=gen.device,
                                dtype=torch.float32).mul_(scale))
    return out


# ----------------------------------------------------------------- norms
def norm_init(cfg: ModelConfig, dtype, device, lead=()) -> Params:
    p = {"scale": torch.ones(*lead, cfg.d_model, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(*lead, cfg.d_model, dtype=dtype,
                                device=device)
    return p


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """RMS norm (eps 1e-6) or LayerNorm (eps 1e-5, the population variance
    as ``jnp.var`` takes it) in f32, result in ``x``'s dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


# ------------------------------------------------------------------ RoPE
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x (..., T, H, Dh), positions (..., T) -> rotated x (half-split
    halves, not interleaved pairs), computed in f32."""
    half = x.shape[-1] // 2
    idx = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions[..., None].float() * freqs            # (..., T, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention
def attn_init(cfg: ModelConfig, gen: torch.Generator, dtype,
              lead=()) -> Params:
    """Attention weights; ``lead`` prefixes every shape (a layer axis)."""
    d, hd, nh, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv
    s = d ** -0.5
    p = {
        "wq": normal_init(gen, (d, nh * hd), s, dtype, lead),
        "wk": normal_init(gen, (d, nkv * hd), s, dtype, lead),
        "wv": normal_init(gen, (d, nkv * hd), s, dtype, lead),
        "wo": normal_init(gen, (nh * hd, d), (nh * hd) ** -0.5, dtype,
                          lead),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd)):
            p[name] = torch.zeros(*lead, n, dtype=dtype, device=gen.device)
    return p


def qkv_proj(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """x (B,T,D) -> q (B,T,H,dh), k/v (B,T,Hkv,dh)."""
    b, t, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, t, cfg.n_heads, cfg.head_dim),
            k.reshape(b, t, cfg.n_kv, cfg.head_dim),
            v.reshape(b, t, cfg.n_kv, cfg.head_dim))


def mha(q: torch.Tensor,            # (B, Tq, H, dh)
        k: torch.Tensor,            # (B, Tk, Hkv, dh)
        v: torch.Tensor,            # (B, Tk, Hkv, dh)
        mask: Optional[torch.Tensor],  # broadcastable to (B,Hkv,G,Tq,Tk)
        ) -> torch.Tensor:
    """GQA attention with f32 logits and softmax; masked logits are -1e30.
    Head ``h`` reads kv head ``h % Hkv`` (the JAX package's grouping)."""
    b, tq, h, dh = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, tq, h // hkv, hkv, dh)
    logits = torch.einsum("bqgkd,btkd->bkgqt", qf, k.float()) * (dh ** -0.5)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqgkd", w, v.float())
    return out.reshape(b, tq, h, dh).to(q.dtype)


def mha_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                window: int = 0, q_chunk: int = 1024) -> torch.Tensor:
    """Causal (+ sliding window) attention computed ``q_chunk`` queries at
    a time (``repro`` layers.py:114), so the logits' working set is
    (B, ., q_chunk, Tk) instead of (B, ., Tq, Tk). The same math as
    ``mha`` under ``causal_mask``; JAX's ``unroll`` is an XLA scan knob
    with no meaning here."""
    b, tq, h, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if q_chunk <= 0 or q_chunk >= tq:
        return mha(q, k, v, causal_mask(tq, tk, q.device, 0, window))
    if tq % q_chunk:
        raise ValueError(f"mha_chunked: {tq} queries are not a multiple "
                         f"of q_chunk={q_chunk}")
    kf, vf = k.float(), v.float()
    qc = q.float().reshape(b, tq // q_chunk, q_chunk, h // hkv, hkv, dh)
    ki = torch.arange(tk, device=q.device)[None, :]
    outs = []
    for c in range(tq // q_chunk):
        qi = c * q_chunk + torch.arange(q_chunk, device=q.device)[:, None]
        m = ki <= qi
        if window > 0:
            m = m & (ki > qi - window)
        logits = torch.einsum("bqgkd,btkd->bkgqt", qc[:, c], kf) \
            * (dh ** -0.5)
        w = torch.softmax(logits.masked_fill(~m, -1e30), dim=-1)
        outs.append(torch.einsum("bkgqt,btkd->bqgkd", w, vf))
    return torch.cat(outs, 1).reshape(b, tq, h, dh).to(q.dtype)


def causal_mask(tq: int, tk: int, device, offset: int = 0,
                window: int = 0) -> torch.Tensor:
    """(1,1,1,Tq,Tk) causal (+ optional sliding window) mask. ``offset``
    is the absolute position of query 0 minus that of key 0."""
    qi = torch.arange(tq, device=device)[:, None] + offset
    ki = torch.arange(tk, device=device)[None, :]
    m = ki <= qi
    if window > 0:
        m = m & (ki > qi - window)
    return m[None, None, None]


def attention_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, window: int = 0,
                    q_chunk: int = 0) -> torch.Tensor:
    """Full-sequence causal self attention of the training path
    (``repro`` layers.py:177): x (B,T,D) -> (B,T,D) after the output
    projection, RoPE only where ``cfg.pos`` is "rope"; ``q_chunk`` > 0
    streams the queries (``mha_chunked``)."""
    b, t, _ = x.shape
    q, k, v = qkv_proj(cfg, p, x)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if q_chunk and q_chunk < t:
        out = mha_chunked(q, k, v, window=window, q_chunk=q_chunk)
    else:
        out = mha(q, k, v, causal_mask(t, t, x.device, 0, window))
    return out.reshape(b, t, cfg.n_heads * cfg.head_dim) @ p["wo"]


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     pos: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, window: int = 0):
    """One-token decode over a ring cache (``repro`` layers.py:191).
    x (B,1,D); pos (B,) absolute positions; k/v_cache (B, C, Hkv, dh)
    with C = min(max_seq, window or max_seq): the token at position ``i``
    lives in slot ``i % C``. Writes this token's K/V into the caches IN
    PLACE and returns (out (B,1,D) after the output projection, k_cache,
    v_cache)."""
    b = x.shape[0]
    c = k_cache.shape[1]
    q, k, v = qkv_proj(cfg, p, x)
    if cfg.pos == "rope":
        q = rope(q, pos[:, None], cfg.rope_theta)
        k = rope(k, pos[:, None], cfg.rope_theta)
    pos = pos.long()
    slot = pos % c
    bidx = torch.arange(b, device=x.device)
    k_cache[bidx, slot] = k[:, 0]
    v_cache[bidx, slot] = v[:, 0]
    # valid keys: the absolute index of cache slot s, rebuilt from pos
    sidx = torch.arange(c, device=x.device)[None, :]
    abs_idx = torch.where(sidx <= slot[:, None],
                          pos[:, None] - (slot[:, None] - sidx),
                          pos[:, None] - (slot[:, None] + c - sidx))
    valid = (abs_idx >= 0) & (abs_idx <= pos[:, None])
    if window > 0:
        valid &= abs_idx > pos[:, None] - window
    out = mha(q, k_cache, v_cache, valid[:, None, None, None, :])
    return (out.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["wo"],
            k_cache, v_cache)


def cross_kv(cfg: ModelConfig, p: Params, enc: torch.Tensor):
    """The encoder output enc (B,Te,D) -> the cross-attention's k, v
    (B,Te,Hkv,dh), each bias added after the reshape to heads."""
    b, te, _ = enc.shape
    k = (enc @ p["wk"]).reshape(b, te, cfg.n_kv, cfg.head_dim)
    v = (enc @ p["wv"]).reshape(b, te, cfg.n_kv, cfg.head_dim)
    if "bk" in p:
        k = k + p["bk"].reshape(cfg.n_kv, cfg.head_dim)
        v = v + p["bv"].reshape(cfg.n_kv, cfg.head_dim)
    return k, v


def cross_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The decoder's queries x (B,T,D) over the encoder's k, v (B,Te,Hkv,
    dh) from ``cross_kv`` (a prefill's, or a decode cache's): no RoPE, no
    mask; -> (B,T,D) after the output projection."""
    b, t, _ = x.shape
    q = (x @ p["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    if "bq" in p:
        q = q + p["bq"].reshape(cfg.n_heads, cfg.head_dim)
    out = mha(q, k, v, None)
    return out.reshape(b, t, cfg.n_heads * cfg.head_dim) @ p["wo"]


def cross_attention_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                          enc: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention over the encoder output (``repro``
    layers.py:223): x (B,T,D), enc (B,Te,D) -> (B,T,D)."""
    return cross_attention(cfg, p, x, *cross_kv(cfg, p, enc))


# ------------------------------------------------------- causal conv
def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time (the SSM's and RG-LRU's short
    conv): x (B,T,C), w (K,C), b (C,); the K taps added one at a time,
    each rounded in ``x``'s dtype, as the JAX package adds them."""
    k, t = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + t] * w[i]
    return out + b


# ------------------------------------------------------------------- MLP
def mlp_init(cfg: ModelConfig, gen: torch.Generator, dtype,
             lead=()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": normal_init(gen, (d, f), d ** -0.5, dtype, lead),
         "w_down": normal_init(gen, (f, d), f ** -0.5, dtype, lead)}
    if cfg.mlp_gated:
        p["w_gate"] = normal_init(gen, (d, f), d ** -0.5, dtype, lead)
    return p


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """SiLU, or GELU in its tanh form: ``jax.nn.gelu`` approximates by
    default, and the erf form differs by ~1e-3."""
    if cfg.act == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Gated: act(x @ W_gate) * (x @ W_up) @ W_down; else act(x @ W_up) @
    W_down."""
    up = x @ p["w_up"]
    h = _act(cfg, x @ p["w_gate"]) * up if cfg.mlp_gated else _act(cfg, up)
    return h @ p["w_down"]
