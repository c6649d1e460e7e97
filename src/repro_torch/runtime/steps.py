"""Step functions (``repro.runtime.steps`` counterparts): the training
step (forward, backward, AdamW), prompt prefill, the greedy decode step
over a ring cache, and the greedy decode step over the coded KV page
pool."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.axes import gather_dim, is_dtensor, mesh_of
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim.adamw import (OptConfig, OptState, adamw_update,
                                     tree_leaves, tree_unflatten)
from repro_torch.runtime import kvbank as kb


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *,
                    remat: bool = True, q_chunk: int = 0, n_micro: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradients (summed in f32 over ``n_micro``
    microbatches of the batch, then divided by ``n_micro``, the loss their
    mean), then ``adamw_update``. Params and optimizer state are updated
    IN PLACE and returned; ``metrics`` are 0-d tensors ``loss``,
    ``grad_norm`` (before clipping) and ``lr_step`` (the step count after
    the update). Every family trains: the batch holds ``tokens`` and,
    where the family takes them, ``patches`` (vision_stub) and ``frames``
    (the encoder-decoder's, required there). A config outside the port
    raises here.

    DTensor params (a ``DeviceMesh``: ``runtime.trainer``) take the same
    step: the forward runs under the mesh (``axes.use_mesh``: the model's
    pins redistribute, plain constants count as replicated), each
    gradient is reduced to its param's placements, the loss comes back
    full."""
    lm.check_slice(cfg)

    def grads_of(leaves, params, batch):
        with torch.enable_grad(), mesh_of(leaves[0]):
            loss = lm.loss_fn(cfg, params, batch, remat=remat,
                              q_chunk=q_chunk)
            # a leaf no layer reads (an empty stack: a hybrid probe of
            # two layers has no attention layer) has a zero gradient
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        if is_dtensor(loss):
            loss = loss.full_tensor()
            grads = [g if tuple(g.placements) == tuple(p.placements)
                     else g.redistribute(p.device_mesh, p.placements)
                     for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    def train_step(params, opt_state: OptState,
                   batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if n_micro <= 1:
            loss, grads = grads_of(leaves, params, batch)
            grads = list(grads)
        else:
            b = batch["tokens"].shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"n_micro={n_micro}")
            micro = [{k: v[i * (b // n_micro):(i + 1) * (b // n_micro)]
                      for k, v in batch.items()} for i in range(n_micro)]
            loss, grads = None, None
            for mb in micro:
                mb_loss, g = grads_of(leaves, params, mb)
                if grads is None:          # 0 + g: JAX's zero-init sum
                    loss, grads = mb_loss, [x.float() for x in g]
                else:
                    loss = loss + mb_loss
                    for acc, x in zip(grads, g):
                        acc.add_(x)
                del g
            for acc in grads:
                acc.div_(n_micro)
            loss = loss / n_micro
        params, opt_state, gnorm = adamw_update(
            opt_cfg, tree_unflatten(params, grads), opt_state, params)
        del grads
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr_step": opt_state.step.float()}

    return train_step


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax over the vocab (B, V) -> (B,); vocab-sharded DTensor
    logits are gathered on the vocab first (one row a sequence)."""
    return torch.argmax(gather_dim(logits, -1), -1)


def make_prefill_step(cfg: ModelConfig, *, q_chunk: int = 0):
    """``prefill_step(params, tokens (B, S), patches=None, frames=None)
    -> (next token (B,), cache)``; ``patches`` (B, P, D) for a
    vision_stub config, ``frames`` (B, F, D) for an encoder-decoder;
    ``q_chunk`` > 0 streams the attention's queries."""

    @torch.no_grad()
    def prefill_step(params, tokens: torch.Tensor,
                     patches: Optional[torch.Tensor] = None,
                     frames: Optional[torch.Tensor] = None):
        logits, cache = lm.prefill(cfg, params, tokens, patches=patches,
                                   frames=frames, q_chunk=q_chunk)
        return _greedy(logits), cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """Greedy decode step over a ring cache:
    ``(params, token (B,), cache) -> (token', cache)``, the cache from
    ``lm.cache_spec`` updated in place."""

    @torch.no_grad()
    def serve_step(params, token: torch.Tensor, cache):
        logits, cache = lm.decode_step(cfg, params, token, cache)
        return _greedy(logits), cache

    return serve_step


def make_pooled_serve_step(cfg: ModelConfig, kvcfg: kb.KVBankConfig, *,
                           recode_budget: Optional[int] = None):
    """Greedy decode step over the coded KV page pool:
    ``(params, token (B,), cache) -> (token', cache)`` with
    ``cache = {"pool": PooledKV, "tele": ServeTelemetry | None}``, the
    pool and the planes updated in place. ``tele=None`` adds no work."""

    @torch.no_grad()
    def pooled_serve_step(params, token: torch.Tensor, cache):
        logits, pool, tele = lm.decode_step_pooled(
            cfg, kvcfg, params, token, cache["pool"], cache["tele"],
            recode_budget=recode_budget)
        return torch.argmax(logits, -1), {"pool": pool, "tele": tele}

    return pooled_serve_step
