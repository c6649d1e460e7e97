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

from repro_torch.axes import from_local, is_dtensor, redistribute
from repro_torch.configs.base import ModelConfig

Params = Dict[str, torch.Tensor]


def normal_init(gen: torch.Generator, shape, scale: float, dtype,
                lead=()) -> torch.Tensor:
    """``scale`` times standard normals of ``(*lead, *shape)`` in ``dtype``,
    drawn in f32 one leading index (one layer) at a time: the f32
    temporary is one layer's leaf, never the stacked model's."""
    out = torch.empty((*lead, *shape), dtype=dtype, device=gen.device)
    if out.is_meta:                   # shapes only (``lm.abstract_params``)
        return out
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
    return (split_heads(q, cfg.n_heads, cfg.head_dim),
            split_heads(k, cfg.n_kv, cfg.head_dim),
            split_heads(v, cfg.n_kv, cfg.head_dim))


def split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, T, n * hd) -> (B, T, n, hd). A DTensor whose last dim is
    sharded over a mesh dim that does not divide ``n`` heads is first
    gathered on that mesh dim (granite's one kv head on a model axis)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        last = x.ndim - 1
        x = redistribute(x, (Replicate() if isinstance(pl, Shard)
                             and pl.dim == last and n % x.device_mesh.size(m)
                             else pl for m, pl in enumerate(x.placements)))
    return x.reshape(*x.shape[:-1], n, hd)


def _mha_local(fn, q, k, v, mask, **kw):
    """``fn`` (``mha``/``mha_chunked``) on DTensor q/k/v, tensor-parallel
    over heads: q stays sharded on its heads (dim 2) where it is; k/v
    are gathered over the mesh dims that shard q's heads or their own.
    Where q's heads are sharded, each local query head ``h`` reads kv
    head ``h % Hkv`` (the grouping of ``mha``), so the region runs as
    plain attention with one kv head per query head; where they are not,
    ``fn`` runs as it does off the mesh. The batch dim keeps its shards
    throughout; k/v's gradients are partial over the head-sharding mesh
    dims. A mask is the causal one, shared by every sequence."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    h, hkv = q.shape[2], k.shape[2]
    q = redistribute(q, (pl if isinstance(pl, Shard) and pl.dim in (0, 2)
                         else Replicate() for pl in q.placements))
    kv_pl, grad_pl, lo = [], [], 0
    for m, pl in enumerate(q.placements):
        heads = isinstance(pl, Shard) and pl.dim == 2
        batch = isinstance(pl, Shard) and pl.dim == 0
        kv_pl.append(Shard(0) if batch else Replicate())
        grad_pl.append(Shard(0) if batch else
                       Partial() if heads else Replicate())
        if heads:
            lo = lo * mesh.size(m) + mesh.get_local_rank(m)

    def local(t):
        return redistribute(t, kv_pl).to_local(grad_placements=grad_pl)

    ql = q.to_local()
    kl, vl = local(k), local(v)
    if ql.shape[2] != h:
        idx = (lo * ql.shape[2] + torch.arange(ql.shape[2],
                                               device=ql.device)) % hkv
        kl, vl = kl[:, :, idx], vl[:, :, idx]
    if mask is not None and mask.shape[0] != 1:
        raise ValueError("attention on a mesh takes a mask shared by every "
                         f"sequence, not one of shape {tuple(mask.shape)}")
    out = fn(ql, kl, vl, mask, **kw) if fn is mha else \
        fn(ql, kl, vl, **kw)
    return from_local(out, mesh, q.placements, q.shape)


def mha(q: torch.Tensor,            # (B, Tq, H, dh)
        k: torch.Tensor,            # (B, Tk, Hkv, dh)
        v: torch.Tensor,            # (B, Tk, Hkv, dh)
        mask: Optional[torch.Tensor],  # broadcastable to (B,Hkv,G,Tq,Tk)
        ) -> torch.Tensor:
    """GQA attention with f32 logits and softmax; masked logits are -1e30.
    Head ``h`` reads kv head ``h % Hkv`` (the JAX package's grouping).
    DTensor operands run tensor-parallel over heads (``_mha_local``)."""
    if is_dtensor(q):
        return _mha_local(mha, q, k, v, mask)
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
    if is_dtensor(q):
        return _mha_local(mha_chunked, q, k, v, None, window=window,
                          q_chunk=q_chunk)
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
    if is_dtensor(k_cache):
        out = _decode_attention_sharded(q, k, v, pos, k_cache, v_cache,
                                        window)
        return (out.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["wo"],
                k_cache, v_cache)
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


def _decode_attention_sharded(q, k, v, pos, k_cache, v_cache, window):
    """``attention_decode``'s write and attention on DTensor caches, layer
    slices (B, C, Hkv, dh) sharded on the batch dim over the batch axes
    and on their kv heads (dim 2) or cache slots (dim 1, context
    parallelism) over ``model`` (``launch.sharding.cache_shardings``).

    q/k/v (this token's, after RoPE) are gathered over every mesh dim but
    the batch's: one token, so the gather is small. Each rank writes the
    token into the slots and kv heads it holds, IN PLACE in its shard,
    and attends with the query heads that read its kv heads (head ``h``
    reads ``h % Hkv``) over its slots; a cache-seq shard combines its
    partial softmax with the other shards' (a max and two sums
    all-reduced over those mesh dims, as flash-decoding does). The
    output is partial over the head-sharding mesh dims (-0.0 in the heads
    a rank did not compute), replicated over the others."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = k_cache.device_mesh
    cpl = tuple(k_cache.placements)
    bpl = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
           else Replicate() for pl in cpl]

    def local(t):
        return redistribute(t, bpl).to_local() if is_dtensor(t) else t

    ql, kl, vl, pl_ = (local(t) for t in (q, k, v, pos))
    kc, vc = k_cache.to_local(), v_cache.to_local()
    b, c_loc, hk_loc, dh = kc.shape
    c, hkv, h = k_cache.shape[1], k_cache.shape[2], q.shape[2]
    head_lo, seq_lo, seq_dims, head_dims = 0, 0, [], []
    for m, pl in enumerate(cpl):
        if isinstance(pl, Shard) and pl.dim == 2:
            head_lo = head_lo * mesh.size(m) + mesh.get_local_rank(m)
            head_dims.append(m)
        elif isinstance(pl, Shard) and pl.dim == 1:
            seq_lo = seq_lo * mesh.size(m) + mesh.get_local_rank(m)
            seq_dims.append(m)
    kv_lo, seq_lo = head_lo * hk_loc, seq_lo * c_loc
    dev = kc.device
    posl = pl_.long()
    slot = posl % c
    lslot = slot - seq_lo
    mine = ((lslot >= 0) & (lslot < c_loc))[:, None, None]
    lslot = lslot.clamp(0, c_loc - 1)
    bidx = torch.arange(b, device=dev)
    for cache, new in ((kc, kl), (vc, vl)):
        cur = cache[bidx, lslot]
        cache[bidx, lslot] = torch.where(
            mine, new[:, 0, kv_lo:kv_lo + hk_loc].to(cache.dtype), cur)
    heads = [j for j in range(h) if kv_lo <= j % hkv < kv_lo + hk_loc]
    hsel = torch.tensor(heads, device=dev)
    kvi = torch.tensor([j % hkv - kv_lo for j in heads], device=dev)
    qf = ql[:, 0, hsel].float()                          # (B, Hs, dh)
    logits = torch.einsum("bhd,bthd->bht", qf, kc[:, :, kvi].float()) \
        * (dh ** -0.5)
    sidx = seq_lo + torch.arange(c_loc, device=dev)[None, :]
    abs_idx = torch.where(sidx <= slot[:, None],
                          posl[:, None] - (slot[:, None] - sidx),
                          posl[:, None] - (slot[:, None] + c - sidx))
    valid = (abs_idx >= 0) & (abs_idx <= posl[:, None])
    if window > 0:
        valid &= abs_idx > posl[:, None] - window
    logits = logits.masked_fill(~valid[:, None, :], -1e30)
    vf = vc[:, :, kvi].float()
    if seq_dims:
        mx = logits.amax(-1, keepdim=True)
        for m in seq_dims:
            mx = funcol.all_reduce(mx, "max", (mesh, m))
        e = torch.exp(logits - mx)
        den, num = e.sum(-1), torch.einsum("bht,bthd->bhd", e, vf)
        for m in seq_dims:
            den = funcol.all_reduce(den, "sum", (mesh, m))
            num = funcol.all_reduce(num, "sum", (mesh, m))
        o = num / den[..., None]
    else:
        o = torch.einsum("bht,bthd->bhd", torch.softmax(logits, -1), vf)
    out = ql.new_full(ql.shape, -0.0)
    out[:, 0, hsel] = o.to(ql.dtype)
    opl = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
           else Partial() if m in head_dims else Replicate()
           for m, pl in enumerate(cpl)]
    return from_local(out, mesh, opl, q.shape)


def cross_kv(cfg: ModelConfig, p: Params, enc: torch.Tensor):
    """The encoder output enc (B,Te,D) -> the cross-attention's k, v
    (B,Te,Hkv,dh), each bias added after the reshape to heads."""
    b, te, _ = enc.shape
    k = split_heads(enc @ p["wk"], cfg.n_kv, cfg.head_dim)
    v = split_heads(enc @ p["wv"], cfg.n_kv, cfg.head_dim)
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
    q = split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
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
