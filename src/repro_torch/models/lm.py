"""Language model of the serving and training slices (``repro.models.lm``
counterpart), every family of the JAX package: the dense decoder, the
MoE family (``models/moe.py`` in place of the MLP), the vision-prefix
family (the dense stack, patch embeddings written over the prompt's
first positions by ``apply_frontend``), the attention-free SSM family
(mamba2: ``models/ssm.py`` mixers), the hybrid family (recurrentgemma:
(rec, rec, local-attn) superblocks of ``models/rglru.py`` blocks and
windowed attention, ``hybrid_layout``) and the audio encoder-decoder
(whisper: ``encode`` over stub frame embeddings with sinusoidal
positions, decoder layers with learned positions and cross-attention).
Training's ``forward``/``loss_fn`` over the layer loop with per-layer
recompute (``backbone``, ``encode``); prompt prefill, the decode step
over a ring cache, which for ssm and hybrid also holds their O(1)
recurrent state and for audio the cross-attention's K/V
(``cache_spec``/``decode_step``), and the decode step over the coded KV
page pool (``decode_step_pooled``).

Params are nested dicts in the JAX package's layout: per-layer leaves
stacked on axis 0 under ``"blocks"`` (the hybrid family: ``"rec_blocks"``
over its recurrent layers, ``"attn_blocks"`` over its attention layers;
the audio family also ``"enc_blocks"``, ``"enc_final_norm"``), matrices
``(d_in, d_out)``, an ``"lm_head"`` ``(d_model, V_pad)`` when the head
is untied, a ``"pos_embed"`` ``(max_seq, d_model)`` table for learned
positions.

Training keeps master params in ``cfg.param_dtype`` and, as JAX does,
runs every op on their compute-dtype cast: the embedding, head and final
norm are cast once a step, each layer's weights inside its (recomputed)
body, so a full-width step never holds a cast copy of the whole stack.
Serving never changes its params: ``cast_params`` casts them once at
load, ``init_params`` draws straight into the compute dtype one layer at
a time, and ``prefill``/``decode_step``/``decode_step_pooled`` take the
cast params (the SSM's ``A_log``, ``D``, ``dt_bias`` and the RG-LRU's
``lam`` included, as JAX casts every float leaf).
JAX's ``unroll``/``chunk_unroll`` are XLA scan knobs with no torch
meaning; the port has no such arguments.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.axes import (from_local, is_dtensor, redistribute, shard,
                             sharded)
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.coded_kv_decode import ops as ckd_ops
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as ly
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.embedding import (coded_parity, embed_init,
                                          embed_lookup, tied_logits)
from repro_torch.obs import serve as obs_serve
from repro_torch.runtime import kvbank as kb

Params = Dict[str, Any]


# the frontend and positions of each family the port serves and trains
_FAMILIES = {"dense": ("none", "rope"), "moe": ("none", "rope"),
             "vlm": ("vision_stub", "rope"), "ssm": ("none", "rope"),
             "hybrid": ("none", "rope"), "audio": ("audio_stub", "learned")}


def check_slice(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside the port: each
    family with its own frontend and positions (the RoPE decoders: dense,
    MoE, the vision prefix, SSM, hybrid; the audio encoder-decoder with
    its stub frames and learned decoder positions), as the JAX package's
    configs combine them. Every such config serves and trains."""
    want = _FAMILIES.get(cfg.family)
    if want is None or (cfg.frontend, cfg.pos) != want \
            or cfg.is_encdec != (cfg.family == "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family with frontend "
            f"{cfg.frontend!r}, positions {cfg.pos!r} and "
            f"{cfg.enc_layers} encoder layers is not a configuration the "
            "port runs (ROADMAP.md: the JAX package's families only)")


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_params(blocks: Params, i: int) -> Params:
    """Layer ``i``'s slice (views) of the stacked block params."""
    return _map(lambda a: a[i], blocks)


def unstack_layers(blocks: Params) -> List[Params]:
    """Every layer's params, by one ``torch.unbind`` per stacked leaf.
    Under autograd this is what a layer loop should take apart: the
    gradients of the slices are stacked once, where ``a[i]`` per layer
    would write a full-size zero gradient of the leaf for every layer."""
    if not isinstance(blocks, dict):
        return list(torch.unbind(blocks))
    parts = {k: unstack_layers(v) for k, v in blocks.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_superblocks, n_rem_rec, n_attn) for the repeating block pattern
    (``repro`` lm.py:64): the remainder layers follow the pattern's
    prefix, where only 'rec' occurs."""
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    per = len(pat)
    n_super = cfg.n_layers // per
    rem = cfg.n_layers - n_super * per
    n_rem_rec = sum(1 for b in pat[:rem] if b == "rec")
    n_attn = n_super * sum(1 for b in pat if b == "attn")
    return n_super, n_rem_rec, n_attn


def _cast(tree, dtype):
    """Float leaves of ``tree`` in ``dtype`` (no copy when they are)."""
    return _map(lambda a: a.to(dtype) if a.is_floating_point() else a,
                tree)


# ======================================================================
# init / load
# ======================================================================
def init_params(cfg: ModelConfig, *, seed: int = 0, device=None,
                dtype: Optional[torch.dtype] = None,
                max_seq: int = 2048) -> Params:
    """Random params in ``dtype`` (serving's default: ``cfg.compute_dtype``;
    training passes ``cfg.param_dtype``) from a seeded ``torch.Generator``
    on ``device`` (the card unless named), drawn in f32 one layer's leaf
    at a time; a learned position table has ``max_seq`` rows (JAX's
    default). The port's own init: the JAX package's ``jax.random`` bits
    are not reproduced; ``convert.params_from_jax`` carries a JAX tree
    across instead."""
    check_slice(cfg)
    device = resolve_device(device)
    if device.type == "meta":
        gen = _MetaGenerator()
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    cd = dtype or getattr(torch, cfg.compute_dtype)
    # the layers are drawn before the embedding (the draw order of the
    # dense family since its first slice)
    if cfg.family == "ssm":
        lead = (cfg.n_layers,)
        blocks = {"blocks": {"norm1": ly.norm_init(cfg, cd, device, lead),
                             "ssm": ssm_mod.ssm_init(cfg, gen, cd, lead)}}
    elif cfg.family == "hybrid":
        n_attn = hybrid_layout(cfg)[2]
        lead = (cfg.n_layers - n_attn,)
        blocks = {"rec_blocks": {
            "norm1": ly.norm_init(cfg, cd, device, lead),
            "norm2": ly.norm_init(cfg, cd, device, lead),
            "rglru": rg.rglru_init(cfg, gen, cd, lead),
            "mlp": ly.mlp_init(cfg, gen, cd, lead)}}
        blocks["attn_blocks"] = _dense_blocks(cfg, gen, cd, device,
                                              (n_attn,))
    elif cfg.family == "audio":
        lead = (cfg.n_layers,)
        dec = _dense_blocks(cfg, gen, cd, device, lead)
        dec["norm3"] = ly.norm_init(cfg, cd, device, lead)
        dec["xattn"] = ly.attn_init(cfg, gen, cd, lead)
        lead = (cfg.enc_layers,)
        blocks = {"blocks": dec, "enc_blocks": {
            "norm1": ly.norm_init(cfg, cd, device, lead),
            "norm2": ly.norm_init(cfg, cd, device, lead),
            "attn": ly.attn_init(cfg, gen, cd, lead),
            "mlp": ly.mlp_init(cfg, gen, cd, lead)},
            "enc_final_norm": ly.norm_init(cfg, cd, device)}
    else:
        blocks = {"blocks": _dense_blocks(cfg, gen, cd, device,
                                          (cfg.n_layers,))}
    params = {"embed": embed_init(cfg, gen, cd),
              "final_norm": ly.norm_init(cfg, cd, device), **blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = ly.normal_init(
            gen, (cfg.d_model, cfg.vocab_pad), cfg.d_model ** -0.5, cd)
    if cfg.pos == "learned":
        params["pos_embed"] = ly.normal_init(gen, (max_seq, cfg.d_model),
                                             0.02, cd)
    return params


class _MetaGenerator:
    """What ``init_params`` asks of a generator, on the ``meta`` device
    (no values are drawn)."""
    device = torch.device("meta")


def abstract_params(cfg: ModelConfig, *, max_seq: int = 2048,
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The param tree as ``meta`` tensors (shapes and dtypes, nothing
    allocated; JAX's ``abstract_params``), in ``cfg.param_dtype`` unless
    ``dtype`` is named."""
    return init_params(cfg, device="meta", max_seq=max_seq,
                       dtype=dtype or getattr(torch, cfg.param_dtype))


def _dense_blocks(cfg, gen, cd, device, lead) -> Params:
    """Stacked pre-norm attention layers with their MLP or MoE block."""
    blocks = {"norm1": ly.norm_init(cfg, cd, device, lead),
              "norm2": ly.norm_init(cfg, cd, device, lead),
              "attn": ly.attn_init(cfg, gen, cd, lead)}
    if cfg.family == "moe":
        blocks["moe"] = moe_mod.moe_init(cfg, gen, cd, lead)
    else:
        blocks["mlp"] = ly.mlp_init(cfg, gen, cd, lead)
    return blocks


def cast_params(cfg: ModelConfig, params: Params, device) -> Params:
    """Serving params: float leaves in the compute dtype on ``device``,
    cast once here instead of in every step. The coded embedding's parity
    is computed once too, on the cast (compute-dtype) bits, exactly the
    bits the JAX package encodes in every lookup."""
    cd = getattr(torch, cfg.compute_dtype)
    out = _map(lambda a: a.to(device=device, dtype=cd)
               if a.is_floating_point() else a.to(device), params)
    if cfg.coded_embedding:
        out["embed"]["par"] = coded_parity(out["embed"]["banks"])
    return out


# ======================================================================
# shared pieces
# ======================================================================
def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor):
    """f32 logits over the padded vocab, through the embedding (tied) or
    ``lm_head``; padding ids masked to -1e30."""
    # eager DTensor propagates forward only: pin the activations to the
    # batch so the head's product keeps the vocab sharded (GSPMD gets
    # there from the logits' pin alone)
    x = shard(x, "batch", *[None] * (x.ndim - 1))
    if cfg.tie_embeddings:
        logits = tied_logits(cfg, params["embed"], x).float()
    else:
        logits = (x @ params["lm_head"].to(x.dtype)).float()
    if cfg.vocab_pad != cfg.vocab:
        pad = torch.arange(cfg.vocab_pad, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)  # out of place: autograd
    return shard(logits, "batch", *[None] * (logits.ndim - 2), "vocab")


def _sinusoid(t: int, d: int, device) -> torch.Tensor:
    """(t, d) sinusoidal positions, computed in f32 (``repro`` lm.py:158):
    sines of every position over 10000^(2i/d), then the cosines."""
    pos = torch.arange(t, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor, cd,
           positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (B, S, D) in ``cd`` (``repro`` lm.py:165), plus,
    for learned positions, the table's rows at ``positions`` (B, S)
    (default 0..S-1), clamped to its last row as JAX's gather clamps."""
    x = embed_lookup(cfg, params["embed"], tokens, cd)
    if cfg.pos == "learned":
        table = params["pos_embed"]
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=tokens.device)
        rows = positions.long().clamp(max=table.shape[0] - 1)
        x = x + table[rows].to(cd)
    # a gather leaves its output partial or replicated: pin the batch
    return shard(x, "batch", None, None)


def _frames(cfg: ModelConfig, frames: Optional[torch.Tensor]):
    """An encoder-decoder's frame embeddings, which it cannot run
    without."""
    if cfg.is_encdec and frames is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs frame "
                         "embeddings (B, F, d_model): pass frames")
    return frames


def _dense_block(cfg, bp, x, positions, q_chunk, window=None):
    """One pre-norm decoder layer of the training path (``repro`` lm.py:
    193), its weights cast to ``x``'s dtype here, inside the (recomputed)
    body; ``window`` defaults to the config's sliding window."""
    bp = _cast(bp, x.dtype)
    h = ly.apply_norm(cfg, bp["norm1"], x)
    x = x + ly.attention_block(
        cfg, bp["attn"], h, positions,
        cfg.sliding_window if window is None else window, q_chunk)
    return x + _ffn(cfg, bp, ly.apply_norm(cfg, bp["norm2"], x))


def _ssm_block(cfg, bp, x):
    """One SSM layer of the training path (``repro`` lm.py:211)."""
    bp = _cast(bp, x.dtype)
    return x + ssm_mod.ssm_block(cfg, bp["ssm"],
                                 ly.apply_norm(cfg, bp["norm1"], x))


def _rec_block(cfg, rp, x):
    """One recurrent layer of the hybrid's training path (``repro``
    lm.py:204)."""
    rp = _cast(rp, x.dtype)
    x = x + rg.rglru_block(cfg, rp["rglru"],
                           ly.apply_norm(cfg, rp["norm1"], x))
    return x + ly.mlp_block(cfg, rp["mlp"], ly.apply_norm(cfg, rp["norm2"], x))


def _cross_tail(cfg, bp, x, xk, xv):
    """An encoder-decoder layer's second half: cross-attention over the
    encoder's K/V (``layers.cross_kv``), then the MLP."""
    x = x + ly.cross_attention(cfg, bp["xattn"],
                               ly.apply_norm(cfg, bp["norm2"], x), xk, xv)
    return x + ly.mlp_block(cfg, bp["mlp"], ly.apply_norm(cfg, bp["norm3"], x))


def _dec_block(cfg, bp, x, positions, enc, q_chunk):
    """One decoder layer of the encoder-decoder's training path (``repro``
    lm.py:275): causal self-attention, cross-attention over ``enc``, the
    MLP."""
    bp = _cast(bp, x.dtype)
    h = ly.apply_norm(cfg, bp["norm1"], x)
    x = x + ly.attention_block(cfg, bp["attn"], h, positions, 0, q_chunk)
    return _cross_tail(cfg, bp, x, *ly.cross_kv(cfg, bp["xattn"], enc))


def _enc_block(cfg, bp, x):
    """One encoder layer (``repro`` lm.py:296): bidirectional
    self-attention (no mask, no RoPE), the MLP."""
    bp = _cast(bp, x.dtype)
    b, t, _ = x.shape
    q, k, v = ly.qkv_proj(cfg, bp["attn"], ly.apply_norm(cfg, bp["norm1"],
                                                         x))
    x = x + ly.mha(q, k, v, None).reshape(b, t, -1) @ bp["attn"]["wo"]
    return x + ly.mlp_block(cfg, bp["mlp"], ly.apply_norm(cfg, bp["norm2"], x))


def _ffn(cfg, bp, h):
    """The block's feed-forward half: the MoE block where the layer has
    one (``repro`` lm.py:197), else the MLP."""
    if "moe" in bp:
        return moe_mod.moe_block(cfg, bp["moe"], h)
    return ly.mlp_block(cfg, bp["mlp"], h)


# the dots policy keeps what JAX's dots_with_no_batch_dims_saveable keeps:
# the outputs of the projections (x @ W lowers to mm), not of the batched
# attention products (bmm)
_SAVED_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(cfg: ModelConfig, body: Callable, remat: bool) -> Callable:
    """``body`` recomputed in the backward pass (``repro`` lm.py:216):
    ``"full"`` saves only the layer's inputs, ``"dots"`` also the
    projection matmuls' outputs."""
    if not remat:
        return body
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _SAVED_DOTS)
    elif cfg.remat_policy != "full":
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: full or dots")
    return lambda *args: checkpoint(body, *args, **kw)


def backbone(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
             remat: bool = True, q_chunk: int = 0,
             enc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every layer over x (B,S,D) in the compute dtype, then the final
    norm (``repro`` lm.py:232), each recomputed unit as JAX's: a layer,
    or for the hybrid a (rec, rec, attn) superblock and then each
    remainder recurrent layer. ``params`` are the master params; ``enc``
    the encoder's output for the audio decoder; ``q_chunk`` > 0 streams
    each attention layer's queries."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if cfg.family == "ssm":
        layer = _remat(cfg, lambda xc, bp: _ssm_block(cfg, bp, xc), remat)
        for bp in unstack_layers(params["blocks"]):
            x = layer(x, bp)
    elif cfg.family == "hybrid":
        n_super, n_rem_rec, _ = hybrid_layout(cfg)
        rec = unstack_layers(params["rec_blocks"])
        attn = unstack_layers(params["attn_blocks"])

        def superblock(xc, r0, r1, ap):
            xc = _rec_block(cfg, r1, _rec_block(cfg, r0, xc))
            return _dense_block(cfg, ap, xc, positions, q_chunk,
                                cfg.local_window)

        sb = _remat(cfg, superblock, remat)
        for i in range(n_super):
            x = sb(x, rec[2 * i], rec[2 * i + 1], attn[i])
        layer = _remat(cfg, lambda xc, rp: _rec_block(cfg, rp, xc), remat)
        for rp in rec[2 * n_super:2 * n_super + n_rem_rec]:
            x = layer(x, rp)
    elif cfg.family == "audio":
        layer = _remat(cfg, lambda xc, bp, e: _dec_block(
            cfg, bp, xc, positions, e, q_chunk), remat)
        for bp in unstack_layers(params["blocks"]):
            x = layer(x, bp, enc)
    else:
        layer = _remat(cfg, lambda xc, bp: _dense_block(
            cfg, bp, xc, positions, q_chunk), remat)
        for bp in unstack_layers(params["blocks"]):
            x = layer(x, bp)
    return ly.apply_norm(cfg, _cast(params["final_norm"], x.dtype), x)


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           remat: bool = True) -> torch.Tensor:
    """The whisper encoder over stub frame embeddings (B, F, D) (``repro``
    lm.py:290): sinusoidal positions added in the compute dtype, each
    layer's bidirectional self-attention and MLP (recomputed in the
    backward pass under ``remat``), the encoder's final norm."""
    cd = getattr(torch, cfg.compute_dtype)
    x = frames.to(cd) + _sinusoid(frames.shape[1], cfg.d_model,
                                  frames.device).to(cd)
    layer = _remat(cfg, lambda xc, bp: _enc_block(cfg, bp, xc), remat)
    for bp in unstack_layers(params["enc_blocks"]):
        x = layer(x, bp)
    return ly.apply_norm(cfg, _cast(params["enc_final_norm"], x.dtype), x)


# the layer stacks, cast inside their (recomputed) bodies
_STACKS = ("blocks", "rec_blocks", "attn_blocks", "enc_blocks")


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, remat: bool = True, q_chunk: int = 0) -> torch.Tensor:
    """Full-sequence logits (B, S, V_pad) f32 (``repro`` lm.py:320), from
    the master params: the embedding (the coded lookup runs on the
    compute-dtype bits, as JAX casts before it looks up), position table
    and head cast once, each layer inside its body. The batch's
    ``patches`` (vision_stub) overwrite the first positions; its
    ``frames`` (an encoder-decoder's, required there) run the encoder."""
    cd = getattr(torch, cfg.compute_dtype)
    top = {k: _cast(v, cd) for k, v in params.items() if k not in _STACKS}
    x = apply_frontend(cfg, _embed(cfg, top, batch["tokens"], cd),
                       batch.get("patches"))
    frames = _frames(cfg, batch.get("frames"))
    enc = None if frames is None else encode(cfg, params, frames,
                                             remat=remat)
    x = backbone(cfg, params, x, remat=remat, q_chunk=q_chunk, enc=enc)
    return _logits(cfg, top, x)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, remat: bool = True, q_chunk: int = 0) -> torch.Tensor:
    """Next-token cross entropy (``repro`` lm.py:340): logsumexp over the
    padded vocab minus the target's logit, mean over B x (S-1). The
    target's logit is indexed, not JAX's where-masked sum over the vocab
    (its sharding trick): the same value, without a (B, S, V) mask."""
    logits = forward(cfg, params, batch, remat=remat, q_chunk=q_chunk)
    lg = logits[:, :-1]
    targets = batch["tokens"][:, 1:].long()
    if is_dtensor(lg) and sharded(lg, -1):
        return _sharded_xent(lg, targets)
    bi = torch.arange(lg.shape[0], device=lg.device)[:, None]
    si = torch.arange(lg.shape[1], device=lg.device)[None, :]
    pick = lg[bi, si, targets]
    return (torch.logsumexp(lg, dim=-1) - pick).mean()


def _sharded_xent(lg, targets):
    """``loss_fn``'s cross entropy on vocab-sharded DTensor logits: the
    logsumexp through a partial max and sum (small all-reduces), and the
    target's logit gathered on the rank that holds it (``_vocab_pick``);
    the logits are never gathered."""
    m = shard(lg.detach().amax(-1, keepdim=True), "batch", None, None)
    lse = shard((lg - m).exp().sum(-1), "batch", None).log() + m[..., 0]
    return (lse - shard(_vocab_pick(lg, targets), "batch", None)).mean()


def _vocab_pick(lg, targets):
    """``lg[b, s, targets[b, s]]`` of DTensor logits (B, S, V) sharded on
    the batch and the vocab: each rank gathers the targets its vocab
    shard holds (0 elsewhere), partial over the vocab-sharding mesh
    dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, last = lg.device_mesh, lg.ndim - 1
    lg = redistribute(lg, (pl if isinstance(pl, Shard) and pl.dim in (0, last)
                           else Replicate() for pl in lg.placements))
    want = tuple(lg.placements)
    tpl = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
           else Replicate() for pl in want]
    if is_dtensor(targets):
        targets = redistribute(targets, tpl).to_local()
    local = lg.to_local()
    lo = 0
    for m, pl in enumerate(want):
        if isinstance(pl, Shard) and pl.dim == last:
            lo = lo * mesh.size(m) + mesh.get_local_rank(m)
    t = targets - lo * local.shape[-1]
    owned = (t >= 0) & (t < local.shape[-1])
    v = local.gather(-1, t.clamp(0, local.shape[-1] - 1)[..., None])[..., 0]
    out_pl = [Partial() if isinstance(pl, Shard) and pl.dim == last
              else pl for pl in want]
    return from_local(v.masked_fill(~owned, 0.0), mesh, out_pl,
                      lg.shape[:-1])


def _block_tail(cfg, bp, x, o):
    """Attention output projection + residual, then the feed-forward
    half."""
    b, t = o.shape[:2]
    x = x + o.reshape(b, t, cfg.n_heads * cfg.head_dim) @ bp["attn"]["wo"]
    return x + _ffn(cfg, bp, ly.apply_norm(cfg, bp["norm2"], x))


# ======================================================================
# serving: prefill, ring decode, pooled decode
# ======================================================================
def cache_spec(cfg: ModelConfig, batch: int, seq_len: int, device,
               enc_frames: int = 0) -> Dict[str, Any]:
    """An empty ring cache (``repro`` lm.py:359): ``pos`` (B,) int32 and,
    by family, ``k``/``v`` (L, B, C, Hkv, dh) in the compute dtype, with
    C = min(seq_len, window) under a sliding (local) window, else seq_len;
    ``ssm``: an ``SSMCache`` over the layers; ``rg``: an ``RGLRUCache``
    over the recurrent layers beside ``k``/``v`` over the attention
    layers; for audio also the cross-attention's ``xk``/``xv`` (L, B,
    enc_frames, Hkv, dh)."""
    cd = getattr(torch, cfg.compute_dtype)
    c: Dict[str, Any] = {"pos": torch.zeros(batch, dtype=torch.int32,
                                            device=device)}

    def kv(n_layers, window):
        clen = min(seq_len, window) if window else seq_len
        shape = (n_layers, batch, clen, cfg.n_kv, cfg.head_dim)
        return torch.zeros(shape, dtype=cd, device=device)

    if cfg.family == "ssm":
        c["ssm"] = ssm_mod.ssm_cache_init(cfg, batch, cd, device,
                                          (cfg.n_layers,))
        return c
    if cfg.family == "hybrid":
        n_attn = hybrid_layout(cfg)[2]
        c["rg"] = rg.rglru_cache_init(cfg, batch, cd, device,
                                      (cfg.n_layers - n_attn,))
        c["k"], c["v"] = kv(n_attn, cfg.local_window), \
            kv(n_attn, cfg.local_window)
        return c
    c["k"], c["v"] = kv(cfg.n_layers, cfg.sliding_window), \
        kv(cfg.n_layers, cfg.sliding_window)
    if cfg.is_encdec:
        shape = (cfg.n_layers, batch, enc_frames, cfg.n_kv, cfg.head_dim)
        c["xk"], c["xv"] = (torch.zeros(shape, dtype=cd, device=device)
                            for _ in range(2))
    return c


def _stack_caches(caches):
    """A list of one-layer NamedTuple caches -> one stacked on axis 0."""
    return type(caches[0])(*(torch.stack(x) for x in zip(*caches)))


def _layer_cache(cache, i: int):
    """Layer ``i``'s views of a stacked NamedTuple cache."""
    return type(cache)(*(x[i] for x in cache))


def _rec_layer(cfg, rp, x, rc=None):
    """One recurrent layer of the hybrid family (``repro`` lm.py:204):
    prefill when ``rc`` is None (returns its cache too), else one decode
    step on ``rc`` in place."""
    h = ly.apply_norm(cfg, rp["norm1"], x)
    if rc is None:
        o, rc = rg.rglru_block(cfg, rp["rglru"], h, return_cache=True)
    else:
        o, rc = rg.rglru_decode(cfg, rp["rglru"], h, rc)
    x = x + o
    return x + ly.mlp_block(cfg, rp["mlp"],
                            ly.apply_norm(cfg, rp["norm2"], x)), rc


def _hybrid_order(cfg):
    """The hybrid stack in depth order: ("rec", index into the recurrent
    layers) or ("attn", index into the attention layers); superblocks of
    (rec, rec, attn), then the remainder recurrent layers."""
    n_super, n_rem_rec, _ = hybrid_layout(cfg)
    order = []
    for i in range(n_super):
        order += [("rec", 2 * i), ("rec", 2 * i + 1), ("attn", i)]
    return order + [("rec", 2 * n_super + j) for j in range(n_rem_rec)]


def _ring(kv: torch.Tensor, cap_full: int, window: int) -> torch.Tensor:
    """(B, S, Hkv, dh) prompt K or V -> ring cache (B, C, Hkv, dh): the
    last C tokens, token ``j`` in slot ``j % C`` (``repro`` lm.py:417)."""
    b, s = kv.shape[:2]
    cap = min(cap_full, window) if window else cap_full
    c = min(s, cap)
    last = kv[:, s - c:]
    if c == s == cap:
        return last
    out = kv.new_zeros((b, cap) + tuple(kv.shape[2:]))
    out[:, torch.arange(s - c, s, device=kv.device) % cap] = last
    return out


def apply_frontend(cfg: ModelConfig, x: torch.Tensor,
                   patches: Optional[torch.Tensor]) -> torch.Tensor:
    """vision_stub: the patch embeddings (B, P, D) written over positions
    [0, P) of the token embeddings x (B, S, D), out of place (``repro``
    lm.py:310). Other frontends, or no patches, leave x as it is."""
    if cfg.frontend != "vision_stub" or patches is None:
        return x
    n = patches.shape[1]
    if n > x.shape[1]:
        raise ValueError(f"{cfg.name}: {n} patch embeddings do not fit a "
                         f"prompt of {x.shape[1]} positions")
    return torch.cat([patches.to(x.dtype), x[:, n:]], 1)


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            max_seq: Optional[int] = None,
            patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, q_chunk: int = 0
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the prompt (B, S); return (last-token logits (B, V) f32,
    cache) with ``pos`` (B,) = S and the family's leaves (``cache_spec``).
    Causal (and, under a sliding or local window, windowed) attention
    over every position, pads included, as in the JAX package. The K/V
    are placed as a ring of capacity ``max(max_seq or S, S)``, cut to the
    window. ``patches`` (B, P, D), for a vision_stub config, overwrite the
    first P positions' embeddings (``apply_frontend``). The SSM mixers
    and RG-LRU blocks hand on their conv tails and f32 states. An
    encoder-decoder encodes ``frames`` (B, F, D), which it requires, and
    hands on each layer's cross-attention K/V over them (``xk``/``xv``,
    biases added). ``q_chunk`` > 0 streams each attention layer's
    queries (``layers.mha_chunked``), as JAX's prefill does."""
    cd = getattr(torch, cfg.compute_dtype)
    b, s = tokens.shape
    cap_full = max(max_seq or s, s)
    positions = torch.arange(s, device=tokens.device)[None, :]
    x = apply_frontend(cfg, _embed(cfg, params, tokens, cd), patches)
    frames = _frames(cfg, frames)
    cache: Dict[str, Any] = {"pos": torch.full((b,), s, dtype=torch.int32,
                                               device=tokens.device)}

    def attn_layer(bp, x, mask, window, enc=None):
        h = ly.apply_norm(cfg, bp["norm1"], x)
        q, k, v = ly.qkv_proj(cfg, bp["attn"], h)
        if cfg.pos == "rope":
            q = ly.rope(q, positions, cfg.rope_theta)
            k = ly.rope(k, positions, cfg.rope_theta)
        if q_chunk and q_chunk < s:
            o = ly.mha_chunked(q, k, v, window=window, q_chunk=q_chunk)
        else:
            o = ly.mha(q, k, v, mask)
        kv = (_ring(k, cap_full, window), _ring(v, cap_full, window))
        if enc is None:
            return (_block_tail(cfg, bp, x, o),) + kv
        x = x + o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ bp["attn"]["wo"]
        xkv = ly.cross_kv(cfg, bp["xattn"], enc)
        return (_cross_tail(cfg, bp, x, *xkv),) + kv + xkv

    ks, vs = [], []
    if cfg.family == "ssm":
        scs = []
        for i in range(cfg.n_layers):
            bp = layer_params(params["blocks"], i)
            o, sc = ssm_mod.ssm_block(
                cfg, bp["ssm"], ly.apply_norm(cfg, bp["norm1"], x),
                return_cache=True)
            x = x + o
            scs.append(sc)
        cache["ssm"] = _stack_caches(scs)
    elif cfg.family == "hybrid":
        window = cfg.local_window
        mask = ly.causal_mask(s, s, tokens.device, 0, window)
        rcs = []                      # _hybrid_order takes them in order
        for kind, j in _hybrid_order(cfg):
            if kind == "rec":
                x, rc = _rec_layer(cfg, layer_params(params["rec_blocks"], j),
                                   x)
                rcs.append(rc)
            else:
                x, k, v = attn_layer(layer_params(params["attn_blocks"], j),
                                     x, mask, window)
                ks.append(k)
                vs.append(v)
        cache["rg"] = _stack_caches(rcs)
    else:
        window = cfg.sliding_window
        mask = ly.causal_mask(s, s, tokens.device, 0, window)
        enc = None if frames is None else encode(cfg, params, frames,
                                                 remat=False)
        xs = []
        for i in range(cfg.n_layers):
            x, k, v, *xkv = attn_layer(layer_params(params["blocks"], i), x,
                                       mask, window, enc)
            ks.append(k)
            vs.append(v)
            xs.append(xkv)
        if enc is not None:
            cache["xk"], cache["xv"] = (torch.stack(t) for t in zip(*xs))
    if cfg.family != "ssm":
        new = (b, min(cap_full, window) if window else cap_full, cfg.n_kv,
               cfg.head_dim)
        cache["k"] = torch.stack(ks) if ks else x.new_zeros((0,) + new)
        cache["v"] = torch.stack(vs) if vs else x.new_zeros((0,) + new)
    x = ly.apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                cache: Dict[str, Any]):
    """One decode step over a ring cache (``repro`` lm.py:538): token (B,)
    -> (logits (B, V) f32, cache), the cache's K/V, conv tails and
    recurrent states updated IN PLACE and its ``pos`` advanced by one. A
    learned position past the table reads its last row (JAX's clamp); an
    encoder-decoder's cross-attention reads the cached ``xk``/``xv``."""
    cd = getattr(torch, cfg.compute_dtype)
    pos = cache["pos"]
    x = _embed(cfg, params, token[:, None], cd, positions=pos[:, None])

    def attn_layer(bp, x, i, window):
        h = ly.apply_norm(cfg, bp["norm1"], x)
        o, _, _ = ly.attention_decode(cfg, bp["attn"], h, pos,
                                      cache["k"][i], cache["v"][i], window)
        x = x + o
        if cfg.is_encdec:
            return _cross_tail(cfg, bp, x, cache["xk"][i], cache["xv"][i])
        return x + _ffn(cfg, bp, ly.apply_norm(cfg, bp["norm2"], x))

    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            bp = layer_params(params["blocks"], i)
            o, _ = ssm_mod.ssm_decode(
                cfg, bp["ssm"], ly.apply_norm(cfg, bp["norm1"], x),
                _layer_cache(cache["ssm"], i))
            x = x + o
    elif cfg.family == "hybrid":
        for kind, j in _hybrid_order(cfg):
            if kind == "rec":
                x, _ = _rec_layer(cfg, layer_params(params["rec_blocks"], j),
                                  x, _layer_cache(cache["rg"], j))
            else:
                x = attn_layer(layer_params(params["attn_blocks"], j), x, j,
                               cfg.local_window)
    else:
        for i in range(cfg.n_layers):
            x = attn_layer(layer_params(params["blocks"], i), x, i,
                           cfg.sliding_window)
    x = ly.apply_norm(cfg, params["final_norm"], x)
    cache["pos"] = pos + 1
    return _logits(cfg, params, x)[:, 0], cache


def decode_step_pooled(cfg: ModelConfig, kvcfg: kb.KVBankConfig,
                       params: Params, token: torch.Tensor, pool: kb.PooledKV,
                       tele: Optional[obs_serve.ServeTelemetry] = None, *,
                       recode_budget: Optional[int] = None):
    """One decode step over the coded KV page pool (the serving path).

    token (B,) -> (logits (B, V) f32, pool, tele), the pool and the
    planes updated in place; ``tele=None`` (telemetry off) does no extra
    work.
    Appends mark the code-status table; every layer writes its new K/V
    into its banks and then gathers its logical K/V through the shared
    read plan (``gather_pool_layer``: the CUDA kernel on the card); the
    ReCoding unit refreshes parity after the layers. With no recode budget
    on a coded pool the encode is fused into the write (bit-identical to
    write-then-full-recode). Slots without a page-table row write nothing
    and keep length 0."""
    if cfg.sliding_window:
        raise ValueError(f"{cfg.name}: the pooled decode step serves global "
                         "attention only; a sliding window uses the ring")
    cd = getattr(torch, cfg.compute_dtype)
    pos = pool.length.clone()
    active = (pool.page_table[:, 0] >= 0) & (pos > 0)
    x = embed_lookup(cfg, params["embed"], token[:, None], cd)

    widx = kb.pool_write_index(kvcfg, pool, active)
    kb.pool_mark_stale(kvcfg, pool, widx)
    len_eff = pos + active.to(pos.dtype)
    plan = kb.pool_plan(kvcfg, pool, length=len_eff)
    lanes = kb.write_lanes(kvcfg, widx)
    fused = recode_budget is None and kb.pool_coded(pool)
    n_keys = kvcfg.max_pages * kvcfg.page
    mask = (torch.arange(n_keys, device=token.device)[None, :]
            < len_eff[:, None])[:, None, None, None, :]
    qpos = pos[:, None]

    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h = ly.apply_norm(cfg, bp["norm1"], x)
        q, k, v = ly.qkv_proj(cfg, bp["attn"], h)
        q = ly.rope(q, qpos, cfg.rope_theta)
        k = ly.rope(k, qpos, cfg.rope_theta)
        kbank, vbank = pool.k_banks[i], pool.v_banks[i]
        kpar, vpar = pool.k_par[i], pool.v_par[i]
        # write before read, on one stream: the gather sees this token
        if fused:
            kb.pool_write_layer_fused(kvcfg, kbank, vbank, kpar, vpar, lanes,
                                      k[:, 0], v[:, 0])
        else:
            kb.pool_write_layer(kvcfg, kbank, vbank, lanes, k[:, 0], v[:, 0])
        k_log, v_log = ckd_ops.gather_pool_layer(
            kbank, vbank, kpar, vpar, pool.page_table, plan.use_parity, cd)
        x = _block_tail(cfg, bp, x, ly.mha(q, k_log, v_log, mask))

    pool.length.copy_(len_eff)
    stale_before = None if tele is None else (~pool.parity_fresh).sum()
    if fused:
        # parity was delta-maintained per layer: refreshing the status
        # table IS the recode
        pool.parity_fresh.fill_(True)
        recoded = stale_before
    else:
        _, recoded = kb.pool_recode(kvcfg, pool, budget=recode_budget)
    if tele is not None:
        needed, bank = kb.pool_read_sets(kvcfg, pool.page_table, len_eff)
        lat = kb.read_latencies(kvcfg, pool.page_table, len_eff,
                                plan.use_parity)
        obs_serve.update_serve_telemetry(
            tele, load=plan.load, needed=needed, bank=bank,
            use_parity=plan.use_parity, latencies=lat,
            stale_before=stale_before, recoded=recoded,
            appended=(widx[0] < kvcfg.n_banks).sum(),
            uncoded_cycles=plan.uncoded_cycles,
            coded_cycles=plan.coded_cycles)
    x = ly.apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x)[:, 0], pool, tele
