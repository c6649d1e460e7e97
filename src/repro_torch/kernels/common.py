"""Shared helpers for the port's coded-memory kernels.

XOR parity over floating-point rows is done on bit views so the coding is
bit-exact for any dtype. The JAX package uses unsigned lanes; PyTorch has
no XOR or ``index_put_`` for uint16/uint32 on the CPU, so the port's lanes
are the SIGNED integer views of the same bits (compare with JAX through
``np.ndarray.view(np.uint16/np.uint32)``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

_LANE_OF = {
    torch.bfloat16: torch.int16,
    torch.float16: torch.int16,
    torch.int16: torch.int16,
    torch.float32: torch.int32,
    torch.int32: torch.int32,
    torch.int8: torch.int8,
}


def lane_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in _LANE_OF:
        raise TypeError(f"no XOR lane type for dtype {dtype}")
    return _LANE_OF[dtype]


def as_lanes(x: torch.Tensor) -> torch.Tensor:
    """The bits of ``x`` as its signed lane dtype (a view, no copy)."""
    return x.view(lane_dtype(x.dtype))


def bxor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bit-exact XOR of two same-dtype tensors (float dtypes via views)."""
    if not a.dtype.is_floating_point:
        return a ^ b
    return (as_lanes(a) ^ as_lanes(b)).view(a.dtype)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. There is no fallback: with no card, ``None`` raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def check_cuda_operand(fn: str, name: str, t: torch.Tensor,
                       dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``: what a hand-written kernel's wrapper accepts."""
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: {name} is on {t.device}, not on the CUDA "
                         "card")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")
