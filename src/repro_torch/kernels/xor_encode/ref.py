"""Plain PyTorch version of the XOR parity encoder: the CPU path of
``ops.encode_parities`` and the card-side yardstick of the CUDA kernel (the
same function as ``repro/kernels/xor_encode/ref.py::encode_parities_ref``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import as_lanes


def encode_parities_plain(banks: torch.Tensor,
                          members: torch.Tensor) -> torch.Tensor:
    """banks (n_data, L, W), members (n_par, k) -1 padded → (n_par, L, W)
    lanes ``p_j = XOR over members m >= 0 of banks[m]`` (a member past the
    last bank is clamped to it, as JAX's gather clamps it)."""
    if banks.dtype.is_floating_point:
        banks = as_lanes(banks)
    nd, rows, w = banks.shape
    out = torch.zeros((members.shape[0], rows, w), dtype=banks.dtype,
                      device=banks.device)
    for mm in range(members.shape[1]):
        m = members[:, mm].long()
        slab = banks[m.clamp(0, nd - 1)]
        out ^= torch.where((m >= 0)[:, None, None], slab, 0)
    return out
