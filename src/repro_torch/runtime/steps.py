"""Serving step functions (``repro.runtime.steps`` counterparts): prompt
prefill, the greedy decode step over a ring cache, and the greedy decode
step over the coded KV page pool."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.runtime import kvbank as kb


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, tokens (B, S)) -> (next token (B,), cache)``."""

    @torch.no_grad()
    def prefill_step(params, tokens: torch.Tensor):
        logits, cache = lm.prefill(cfg, params, tokens)
        return torch.argmax(logits, -1), cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """Greedy decode step over a ring cache:
    ``(params, token (B,), cache) -> (token', cache)``, the cache from
    ``lm.cache_spec`` updated in place."""

    @torch.no_grad()
    def serve_step(params, token: torch.Tensor, cache):
        logits, cache = lm.decode_step(cfg, params, token, cache)
        return torch.argmax(logits, -1), cache

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
