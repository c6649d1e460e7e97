"""Public wrappers of the XOR parity encoder (``repro`` counterpart:
``kernels/xor_encode/ops.py``, and the region encode of
``core/dynamic.py::_encode_region_data``).

Dispatch is by the tensors' device, with no switch and no fallback: CUDA
tensors go through the hand-written kernel (which launches or raises), CPU
tensors through the plain PyTorch version. ``calls`` counts the calls of
``encode_parities`` and ``encode_regions`` on any device; on the card it
must equal the kernel's ``launches``.

The point axis: banks (B, n_data, L, W) encode B points' parities in one
launch; the kernel takes B and the one-point member table, and each point
XORs its own banks. ``encode_regions`` writes every completing point's
region encode into a copy of the batched parity state in one launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import as_lanes
from repro_torch.kernels.xor_encode.kernel import (MEMBER_DTYPES, N_MEMBERS,
                                                   encode_parities_cuda,
                                                   encode_regions_cuda)
from repro_torch.kernels.xor_encode.ref import (encode_parities_plain,
                                                encode_regions_plain)

calls = 0


def member_table(members, device) -> torch.Tensor:
    """``members`` (n_par, <= 3), a list, array or tensor, as the kernel's
    (n_par, 3) table on ``device``, padded with -1: an (n_par, 3) int32 or
    int64 tensor already there is taken as it is (no copy), anything else
    becomes int32."""
    if isinstance(members, torch.Tensor) and members.dtype in MEMBER_DTYPES \
            and members.device == torch.device(device) \
            and members.dim() == 2 and members.shape[1] == N_MEMBERS \
            and members.is_contiguous():
        return members
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
    dev = banks.device.type
    if dev == "cuda":
        return encode_parities_cuda(banks, members)
    if dev == "cpu":
        return encode_parities_plain(banks, members)
    raise ValueError(f"encode_parities: no datapath for device {dev}")


def encode_regions(p, tables, banks_data: torch.Tensor,
                   parity_data: torch.Tensor, done) -> torch.Tensor:
    """Dynamic coding's completion datapath for B points: ``parity_data``
    (B, n_par, Lp) as a new tensor with each completing point's slot rows
    set to the XOR parities of its region's rows of ``banks_data`` (B,
    n_data, L). ``done`` lists (point, region, slot, rs_a) host ints; they
    go to the card as one (C, 4) int32 block and every point's encode is
    one ``xor_encode`` launch there (``p``: ``MemParams``, its
    ``region_size``; ``tables``: ``JTables``, its ``par_members``). The
    input state is left as it is (``on_cycle`` hooks hold it)."""
    global calls
    calls += 1
    B = banks_data.shape[0]
    if any(not 0 <= b < B for b, *_ in done):
        raise ValueError(f"encode_regions: a point of {done} outside the "
                         f"batch of {B}")
    dev = banks_data.device.type
    if dev == "cuda":
        block = torch.tensor(done, dtype=torch.int32).to(banks_data.device)
        return encode_regions_cuda(banks_data, parity_data,
                                   tables.par_members, block, p.region_size)
    if dev == "cpu":
        return encode_regions_plain(banks_data, parity_data,
                                    tables.par_members, done, p.region_size)
    raise ValueError(f"encode_regions: no datapath for device {dev}")
