"""The assigned input shapes x per-arch input specs (``repro.launch.shapes``
counterpart). The specs are tensors on the ``meta`` device: shapes and
dtypes with nothing allocated, the counterpart of JAX's
``ShapeDtypeStruct``.

  train_4k     seq 4,096   global_batch 256   -> train step
  prefill_32k  seq 32,768  global_batch 32    -> prefill step
  decode_32k   seq 32,768  global_batch 128   -> serve step (KV at seq_len)
  long_500k    seq 524,288 global_batch 1     -> serve step; sub-quadratic
               archs only (ssm / hybrid / sliding window): full-attention
               archs skip (no sub-quadratic path).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch — no sub-quadratic path at "
                       "524k context (DESIGN.md §6)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """The (train/prefill) host batch as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    cd = getattr(torch, cfg.compute_dtype)
    batch: Dict[str, Any] = {"tokens": _meta((b, s), torch.int32)}
    if cfg.is_encdec:
        batch["frames"] = _meta((b, cfg.enc_frames, cfg.d_model), cd)
    if cfg.frontend == "vision_stub":
        batch["patches"] = _meta((b, cfg.n_patches, cfg.d_model), cd)
    return batch


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> Any:
    """The decode shapes' KV/state cache as meta tensors."""
    from repro_torch.models import lm
    return lm.cache_spec(cfg, shape.global_batch, shape.seq_len,
                         device="meta", enc_frames=cfg.enc_frames)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """All inputs of the step function of this (arch x shape) cell."""
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_specs(cfg, shape)}
    return {"token": _meta((shape.global_batch,), torch.int32),
            "cache": cache_specs(cfg, shape)}


def default_q_chunk(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Query-block size for full-sequence shapes (0 = unchunked
    attention): (B, H, S, S) scores at S=4096 are far past any device's
    memory, so the query-block path bounds the live scores to (B, H,
    q_chunk, S)."""
    if shape.kind == "decode" or shape.seq_len < 4_096:
        return 0
    return 1_024 if shape.seq_len <= 8_192 else 2_048
