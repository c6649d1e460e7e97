"""Language model of the serving and training slices (``repro.models.lm``
counterpart): the dense decoder family, which training covers, and, for
serving, the MoE family (``models/moe.py`` in place of the MLP), the
vision-prefix family (the dense stack, patch embeddings written over the
prompt's first positions by ``apply_frontend``), the attention-free SSM
family (mamba2: ``models/ssm.py`` mixers) and the hybrid family
(recurrentgemma: (rec, rec, local-attn) superblocks of ``models/rglru.py``
blocks and windowed attention, ``hybrid_layout``); training's
``forward``/``loss_fn`` over the layer loop with per-layer recompute
(``backbone``); prompt prefill, the decode step over a ring cache, which
for ssm and hybrid also holds their O(1) recurrent state
(``cache_spec``/``decode_step``), and the decode step over the coded KV
page pool (``decode_step_pooled``).

Params are nested dicts in the JAX package's layout: per-layer leaves
stacked on axis 0 under ``"blocks"`` (the hybrid family: ``"rec_blocks"``
over its recurrent layers, ``"attn_blocks"`` over its attention layers),
matrices ``(d_in, d_out)``, an ``"lm_head"`` ``(d_model, V_pad)`` when
the head is untied.

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


def check_slice(cfg: ModelConfig, *, training: bool = False) -> None:
    """Raise ``NotImplementedError`` for a config outside the ported
    slice: the RoPE decoder (RMSNorm or LayerNorm, SwiGLU or an ungated
    GELU MLP, a tied or untied head, global or sliding-window attention)
    of the dense family; for serving also the MoE family, the vision
    prefix (``vlm`` with ``frontend="vision_stub"``), the SSM family and
    the hybrid (RG-LRU + local attention) family."""
    served = {"dense": "none", "moe": "none", "vlm": "vision_stub",
              "ssm": "none", "hybrid": "none"}
    if cfg.family not in served or cfg.frontend != served[cfg.family] \
            or cfg.is_encdec or cfg.pos != "rope":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported (ROADMAP.md, "
            "queue 1 item 4: the other model families)")
    if training and cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.family} family is not ported "
            "(ROADMAP.md, queue 1 item 4); the port serves it")


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
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random params in ``dtype`` (serving's default: ``cfg.compute_dtype``;
    training passes ``cfg.param_dtype``) from a seeded ``torch.Generator``
    on ``device`` (the card unless named), drawn in f32 one layer's leaf
    at a time. The port's own init: the JAX package's ``jax.random`` bits
    are not reproduced; ``convert.params_from_jax`` carries a JAX tree
    across instead."""
    check_slice(cfg)
    device = resolve_device(device)
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
    else:
        blocks = {"blocks": _dense_blocks(cfg, gen, cd, device,
                                          (cfg.n_layers,))}
    params = {"embed": embed_init(cfg, gen, cd),
              "final_norm": ly.norm_init(cfg, cd, device), **blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = ly.normal_init(
            gen, (cfg.d_model, cfg.vocab_pad), cfg.d_model ** -0.5, cd)
    return params


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
    if cfg.tie_embeddings:
        logits = tied_logits(cfg, params["embed"], x).float()
    else:
        logits = (x @ params["lm_head"].to(x.dtype)).float()
    if cfg.vocab_pad == cfg.vocab:
        return logits
    pad = torch.arange(cfg.vocab_pad, device=x.device) >= cfg.vocab
    return logits.masked_fill(pad, -1e30)      # out of place: autograd


def _dense_block(cfg, bp, x, positions, q_chunk):
    """One pre-norm decoder layer of the training path (``repro`` lm.py:
    193), its weights cast to ``x``'s dtype here, inside the (recomputed)
    body."""
    bp = _cast(bp, x.dtype)
    h = ly.apply_norm(cfg, bp["norm1"], x)
    x = x + ly.attention_block(cfg, bp["attn"], h, positions,
                               cfg.sliding_window, q_chunk)
    return x + _ffn(cfg, bp, ly.apply_norm(cfg, bp["norm2"], x))


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
             remat: bool = True, q_chunk: int = 0) -> torch.Tensor:
    """Every layer over x (B,S,D) in the compute dtype, then the final
    norm (``repro`` lm.py:232, the dense branch). ``params`` are the
    master params; ``q_chunk`` > 0 streams each layer's queries."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    layer = _remat(cfg, lambda xc, bp: _dense_block(cfg, bp, xc, positions,
                                                    q_chunk), remat)
    for bp in unstack_layers(params["blocks"]):
        x = layer(x, bp)
    return ly.apply_norm(cfg, _cast(params["final_norm"], x.dtype), x)


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, remat: bool = True, q_chunk: int = 0) -> torch.Tensor:
    """Full-sequence logits (B, S, V_pad) f32 (``repro`` lm.py:320), from
    the master params: the embedding (the coded lookup runs on the
    compute-dtype bits, as JAX casts before it looks up) and head cast
    once, each layer inside its body."""
    cd = getattr(torch, cfg.compute_dtype)
    top = {k: _cast(v, cd) for k, v in params.items() if k != "blocks"}
    x = embed_lookup(cfg, top["embed"], batch["tokens"], cd)
    x = backbone(cfg, params, x, remat=remat, q_chunk=q_chunk)
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
    bi = torch.arange(lg.shape[0], device=lg.device)[:, None]
    si = torch.arange(lg.shape[1], device=lg.device)[None, :]
    pick = lg[bi, si, targets]
    return (torch.logsumexp(lg, dim=-1) - pick).mean()


def _block_tail(cfg, bp, x, o):
    """Attention output projection + residual, then the feed-forward
    half."""
    b, t = o.shape[:2]
    x = x + o.reshape(b, t, cfg.n_heads * cfg.head_dim) @ bp["attn"]["wo"]
    return x + _ffn(cfg, bp, ly.apply_norm(cfg, bp["norm2"], x))


# ======================================================================
# serving: prefill, ring decode, pooled decode
# ======================================================================
def cache_spec(cfg: ModelConfig, batch: int, seq_len: int, device
               ) -> Dict[str, Any]:
    """An empty ring cache (``repro`` lm.py:359): ``pos`` (B,) int32 and,
    by family, ``k``/``v`` (L, B, C, Hkv, dh) in the compute dtype, with
    C = min(seq_len, window) under a sliding (local) window, else seq_len;
    ``ssm``: an ``SSMCache`` over the layers; ``rg``: an ``RGLRUCache``
    over the recurrent layers beside ``k``/``v`` over the attention
    layers."""
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
            patches: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the prompt (B, S); return (last-token logits (B, V) f32,
    cache) with ``pos`` (B,) = S and the family's leaves (``cache_spec``).
    Causal (and, under a sliding or local window, windowed) attention
    over every position, pads included, as in the JAX package. The K/V
    are placed as a ring of capacity ``max(max_seq or S, S)``, cut to the
    window. ``patches`` (B, P, D), for a vision_stub config, overwrite the
    first P positions' embeddings (``apply_frontend``). The SSM mixers
    and RG-LRU blocks hand on their conv tails and f32 states."""
    cd = getattr(torch, cfg.compute_dtype)
    b, s = tokens.shape
    cap_full = max(max_seq or s, s)
    positions = torch.arange(s, device=tokens.device)[None, :]
    x = apply_frontend(cfg, embed_lookup(cfg, params["embed"], tokens, cd),
                       patches)
    cache: Dict[str, Any] = {"pos": torch.full((b,), s, dtype=torch.int32,
                                               device=tokens.device)}

    def attn_layer(bp, x, mask, window):
        h = ly.apply_norm(cfg, bp["norm1"], x)
        q, k, v = ly.qkv_proj(cfg, bp["attn"], h)
        q = ly.rope(q, positions, cfg.rope_theta)
        k = ly.rope(k, positions, cfg.rope_theta)
        x = _block_tail(cfg, bp, x, ly.mha(q, k, v, mask))
        return x, _ring(k, cap_full, window), _ring(v, cap_full, window)

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
        for i in range(cfg.n_layers):
            x, k, v = attn_layer(layer_params(params["blocks"], i), x, mask,
                                 window)
            ks.append(k)
            vs.append(v)
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
    recurrent states updated IN PLACE and its ``pos`` advanced by one."""
    cd = getattr(torch, cfg.compute_dtype)
    pos = cache["pos"]
    x = embed_lookup(cfg, params["embed"], token[:, None], cd)

    def attn_layer(bp, x, i, window):
        h = ly.apply_norm(cfg, bp["norm1"], x)
        o, _, _ = ly.attention_decode(cfg, bp["attn"], h, pos,
                                      cache["k"][i], cache["v"][i], window)
        x = x + o
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
