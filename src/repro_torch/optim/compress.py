"""int8 block quantization of gradients with error feedback
(``repro.optim.compress`` counterpart, bit for bit): each leaf is cut
into blocks of ``BLOCK`` values, each block quantized to int8 with its
own f32 scale; the residual ``g - dequantize(quantize(g))`` is what error
feedback adds to the next step's gradient."""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_unflatten

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    n = x.numel()
    flat = x.reshape(-1)
    pad = (-n) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK), n


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (q int8 (nb, BLOCK), scale f32 (nb, 1))."""
    blocks, _ = _pad_to_block(g.float())
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = amax / 127.0 + 1e-12
    q = torch.round(blocks / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    flat = (q.float() * scale).reshape(-1)[:n]
    return flat.reshape(tuple(shape)).to(dtype)


def compress_tree(grads: Any):
    """Tree -> (list of (q, scale) per leaf, residual f32 tree, the tree
    itself as the structure ``decompress_list`` rebuilds)."""
    comp: List[Tuple[torch.Tensor, torch.Tensor]] = []
    resid = []
    for g in tree_leaves(grads):
        q, s = compress_int8(g)
        comp.append((q, s))
        resid.append(g.float() - decompress_int8(q, s, g.shape,
                                                 torch.float32))
    return comp, tree_unflatten(grads, resid), grads


def decompress_list(comp_leaves, shapes, dtypes, treedef) -> Any:
    return tree_unflatten(treedef, [
        decompress_int8(q, s, sh, dt)
        for (q, s), sh, dt in zip(comp_leaves, shapes, dtypes)])
