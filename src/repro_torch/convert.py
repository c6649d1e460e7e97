"""Carry params from the JAX package to the port.

``params_from_jax(cfg, tree, device)`` takes the JAX param tree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's tree:
the same nesting, the same ``(d_in, d_out)`` layout (the port computes
``x @ W`` as JAX does, so nothing is transposed), the same dtypes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                    # a writable, contiguous copy
    if a.dtype.name == "bfloat16":     # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any],
                    device) -> Dict[str, Any]:
    """The JAX tree (numpy leaves) as the port's params on ``device``."""
    lm.check_slice(cfg)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(np.asarray(node), device)

    return conv(tree)
