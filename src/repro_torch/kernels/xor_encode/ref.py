"""Plain PyTorch versions of the XOR parity encoder: the CPU path of
``ops.encode_parities`` and ``ops.encode_regions`` and the card-side
yardsticks of the CUDA kernels (``encode_parities_plain`` is the same
function as ``repro/kernels/xor_encode/ref.py::encode_parities_ref``,
``encode_regions_plain`` the region encode of
``repro/core/dynamic.py::_encode_region_data`` for several points)."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import as_lanes


def encode_parities_plain(banks: torch.Tensor,
                          members: torch.Tensor) -> torch.Tensor:
    """banks (n_data, L, W), members (n_par, k) -1 padded → (n_par, L, W)
    lanes ``p_j = XOR over members m >= 0 of banks[m]`` (a member past the
    last bank is clamped to it, as JAX's gather clamps it). Banks (B,
    n_data, L, W) give (B, n_par, L, W), each point XORing its own banks
    (the members clamped inside the point)."""
    if banks.dtype.is_floating_point:
        banks = as_lanes(banks)
    if banks.dim() == 4:
        B, nd = banks.shape[:2]
        m = members.long()
        off = torch.arange(B, device=banks.device)[:, None, None] * nd
        flat = torch.where(m >= 0, m.clamp(max=nd - 1) + off, -1)
        out = encode_parities_plain(banks.flatten(0, 1), flat.flatten(0, 1))
        return out.view(B, -1, *out.shape[1:])
    nd, rows, w = banks.shape
    out = torch.zeros((members.shape[0], rows, w), dtype=banks.dtype,
                      device=banks.device)
    for mm in range(members.shape[1]):
        m = members[:, mm].long()
        slab = banks[m.clamp(0, nd - 1)]
        out ^= torch.where((m >= 0)[:, None, None], slab, 0)
    return out


def encode_regions_plain(banks_data: torch.Tensor,
                         parity_data: torch.Tensor, members: torch.Tensor,
                         done, region_size: int) -> torch.Tensor:
    """``parity_data`` (B, n_par, Lp, *lanes) as a new tensor with each
    completing point's slot rows set to the XOR parities of its region's
    rows of ``banks_data`` (B, n_data, L, *lanes). ``done`` lists (point,
    region, slot, rs_a): host ints or a (C, 4) int32 tensor. The rows are
    gathered with the clamped indices of ``repro/core/dynamic.py:63``,
    lanes at offsets >= ``rs_a`` write 0, and the slot's start is clamped
    so the region fits, as ``dynamic_update_slice`` clamps it."""
    if isinstance(done, torch.Tensor):
        done = done.tolist()
    out = parity_data.clone()
    if not done:
        return out
    rs = region_size
    B, nd, n_rows = banks_data.shape[:3]
    banks = banks_data.reshape(B, nd, n_rows, -1)
    dev = banks.device
    off = torch.arange(rs, device=dev)
    rows = torch.stack([banks[b][:, (region * rs_a + off).clamp(
        0, n_rows - 1)] for b, region, _, rs_a in done])  # (C, nd, rs, W)
    vals = encode_parities_plain(rows, members)            # (C, n_par, rs, W)
    flat = out.view(B, out.shape[1], out.shape[2], -1)
    for k, (b, _, slot, rs_a) in enumerate(done):
        start = min(max(slot, 0) * rs, parity_data.shape[2] - rs)
        flat[b, :, start:start + rs] = torch.where((off < rs_a)[:, None],
                                                   vals[k], 0)
    return out
