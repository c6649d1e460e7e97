"""Public wrapper of the XOR parity encoder (``repro`` counterpart:
``kernels/xor_encode/ops.py``).

Dispatch is by the tensors' device, with no switch and no fallback: CUDA
tensors go through the hand-written kernel (which launches or raises), CPU
tensors through the plain PyTorch version. ``calls`` counts the calls of
``encode_parities`` on any device; on the card it must equal the kernel's
``launches``.

The point axis: banks (B, n_data, L, W) encode B points' parities in one
launch, on the banks viewed as (B·n_data, L, W) with each point's member
ids offset by ``b · n_data`` (the kernel takes ``n_data`` and ``n_par`` at
run time, so the CUDA source is the one-point kernel).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import as_lanes
from repro_torch.kernels.xor_encode.kernel import (N_MEMBERS,
                                                   encode_parities_cuda)
from repro_torch.kernels.xor_encode.ref import encode_parities_plain

calls = 0


def member_table(members, device) -> torch.Tensor:
    """``members`` (n_par, <= 3), a list, array or tensor, as the kernel's
    (n_par, 3) int32 table on ``device``, padded with -1 (no copy when it
    already is one)."""
    m = torch.as_tensor(members, dtype=torch.int32, device=device)
    if m.dim() != 2 or m.shape[1] > N_MEMBERS:
        raise ValueError(f"members must be (n_par, <= {N_MEMBERS})")
    if m.shape[1] < N_MEMBERS:
        m = torch.cat([m, m.new_full((m.shape[0], N_MEMBERS - m.shape[1]),
                                     -1)], 1)
    return m.contiguous()


def encode_parities(banks: torch.Tensor, members) -> torch.Tensor:
    """Encode parity banks ``p_j = XOR_m banks[m]`` bit for bit, any lane
    or float dtype: banks (n_data, L, W) give (n_par, L, W), and banks
    (B, n_data, L, W) give every point's (B, n_par, L, W) from one launch.
    Float banks are viewed as their signed integer lanes; the parities come
    back as those lanes (code symbols, not numbers). ``members`` is
    anything ``member_table`` takes."""
    global calls
    calls += 1
    if banks.dtype.is_floating_point:
        banks = as_lanes(banks)
    members = member_table(members, banks.device)
    if banks.dim() == 4:
        B, nd = banks.shape[:2]
        if B > 1:
            off = torch.arange(B, dtype=torch.int32,
                               device=banks.device)[:, None, None] * nd
            members = torch.where(members >= 0, members + off, -1)
        out = _encode(banks.flatten(0, 1), members.reshape(-1, N_MEMBERS))
        return out.view(B, -1, *out.shape[1:])
    return _encode(banks, members)


def _encode(banks: torch.Tensor, members: torch.Tensor) -> torch.Tensor:
    dev = banks.device.type
    if dev == "cuda":
        return encode_parities_cuda(banks, members)
    if dev == "cpu":
        return encode_parities_plain(banks, members)
    raise ValueError(f"encode_parities: no datapath for device {dev}")
