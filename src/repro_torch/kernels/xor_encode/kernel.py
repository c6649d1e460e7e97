"""Wrappers of the CUDA XOR parity encoder (``csrc/xor_encode.cu``), the
Hopper counterpart of ``encode_parities_pallas``
(``repro/kernels/xor_encode/kernel.py:37``): ``encode_parities_cuda``
encodes whole banks of one or B points, ``encode_regions_cuda`` dynamic
coding's completing region encodes straight into a copy of the parity
state.

The wrappers take CUDA tensors only: they check device, dtype, contiguity
and shape and raise on anything else, allocate the output, launch on
PyTorch's current stream and raise if the launch was refused. They never
fall back to the plain version. ``launches`` counts the launches of both.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_cuda_operand

launches = 0
LANES = (torch.int8, torch.int16, torch.int32)
N_MEMBERS = 3                          # MAX_SIBS + 1
MEMBER_DTYPES = (torch.int32, torch.int64)


def _lib() -> ctypes.CDLL:
    lib = build.library("xor_encode")
    if lib.xor_encode.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.xor_encode.argtypes = [p, p, p, i, i, i, ll, i, p]
        lib.xor_encode.restype = ctypes.c_int
        lib.xor_encode_regions.argtypes = [p, p, p, p, i, i, i, i, ll, ll, ll,
                                           i, i, p]
        lib.xor_encode_regions.restype = ctypes.c_int
        lib.xor_encode_error_string.argtypes = [ctypes.c_int]
        lib.xor_encode_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn: str, err: int, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + lib.xor_encode_error_string(err).decode())


def _check_members(fn: str, members: torch.Tensor) -> int:
    """Raise unless ``members`` is an (n_par, 3) int32/int64 CUDA table;
    return n_par."""
    if members.dim() != 2:
        raise ValueError(f"{fn}: members must be (n_par, {N_MEMBERS})")
    if members.dtype not in MEMBER_DTYPES:
        raise TypeError(f"{fn}: members has dtype {members.dtype}, expected "
                        "int32 or int64")
    check_cuda_operand(fn, "members", members, members.dtype,
                       (members.shape[0], N_MEMBERS))
    return members.shape[0]


def _row_bytes(t: torch.Tensor, lead: int) -> int:
    n = t.element_size()
    for w in t.shape[lead:]:
        n *= w
    return n


def encode_parities_cuda(banks: torch.Tensor,
                         members: torch.Tensor) -> torch.Tensor:
    """Parity lanes on the card, bit-exact vs ``ref.encode_parities_plain``:
    banks (n_data, L, W) give (n_par, L, W), and banks (B, n_data, L, W)
    every point's (B, n_par, L, W) from one launch, each point XORing its
    own banks. int8/int16/int32 lanes; ``members`` (n_par, 3) int32 or
    int64, -1 padded, the same for every point (a member past the last
    bank is clamped to it)."""
    global launches
    fn = "encode_parities_cuda"
    lanes = banks.dtype
    if lanes not in LANES:
        raise TypeError(f"{fn}: banks must be int8/int16/int32 lanes, got "
                        f"{lanes}")
    if banks.dim() not in (3, 4):
        raise ValueError(f"{fn}: banks must be (n_data, L, W) or (B, "
                         "n_data, L, W)")
    npar = _check_members(fn, members)
    check_cuda_operand(fn, "banks", banks, lanes, banks.shape)
    if banks.device != members.device:
        raise ValueError(f"{fn}: operands on different cards")
    lead = banks.dim() - 3
    B = banks.shape[0] if lead else 1
    nd = banks.shape[lead]
    out = torch.empty(tuple(banks.shape[:lead]) + (npar,)
                      + tuple(banks.shape[lead + 1:]), dtype=lanes,
                      device=banks.device)
    if out.numel() == 0:
        return out
    if nd == 0:
        raise ValueError(f"{fn}: no data banks to encode")
    with torch.cuda.device(banks.device):
        lib = _lib()
        err = lib.xor_encode(banks.data_ptr(), members.data_ptr(),
                             out.data_ptr(), B, nd, npar,
                             _row_bytes(banks, lead + 1),
                             members.element_size(),
                             torch.cuda.current_stream().cuda_stream)
    _check("xor_encode", err, lib)
    launches += 1
    return out


def encode_regions_cuda(banks_data: torch.Tensor, parity_data: torch.Tensor,
                        members: torch.Tensor, done: torch.Tensor,
                        region_size: int) -> torch.Tensor:
    """A copy of ``parity_data`` (B, n_par, Lp, *lanes) whose slot rows are
    rewritten for each completing encode of ``done`` ((C, 4) int32 on the
    card: point, region, slot, rs_a), bit-exact vs
    ``ref.encode_regions_plain``: the parities of the region's rows
    ``clamp(region * rs_a + off, 0, L - 1)`` of the point's ``banks_data``
    (B, n_data, L, *lanes), written from the clamped start
    ``min(max(slot, 0) * region_size, Lp - region_size)``, 0 at offsets >=
    rs_a. One clone and one launch; C = 0 launches nothing."""
    global launches
    fn = "encode_regions_cuda"
    lanes = banks_data.dtype
    if lanes not in LANES:
        raise TypeError(f"{fn}: banks must be int8/int16/int32 lanes, got "
                        f"{lanes}")
    if banks_data.dim() < 3 or parity_data.dim() != banks_data.dim():
        raise ValueError(f"{fn}: banks_data must be (B, n_data, L, ...) and "
                         "parity_data (B, n_par, Lp, ...)")
    B, nd, rows = banks_data.shape[:3]
    npar = _check_members(fn, members)
    lane_shape = tuple(banks_data.shape[3:])
    prows = parity_data.shape[2]
    check_cuda_operand(fn, "banks_data", banks_data, lanes, banks_data.shape)
    check_cuda_operand(fn, "parity_data", parity_data, lanes,
                       (B, npar, prows) + lane_shape)
    check_cuda_operand(fn, "done", done, torch.int32, (done.shape[0], 4))
    if len({t.device for t in (banks_data, parity_data, members,
                               done)}) != 1:
        raise ValueError(f"{fn}: operands on different cards")
    if not 0 < region_size <= prows:
        raise ValueError(f"{fn}: region_size {region_size} outside (0, "
                         f"{prows}]")
    out = parity_data.clone()
    if done.shape[0] == 0 or out.numel() == 0:
        return out
    if nd == 0 or rows == 0:
        raise ValueError(f"{fn}: no data rows to encode")
    with torch.cuda.device(banks_data.device):
        lib = _lib()
        err = lib.xor_encode_regions(
            banks_data.data_ptr(), members.data_ptr(), done.data_ptr(),
            out.data_ptr(), done.shape[0], B, nd, npar, rows, prows,
            _row_bytes(banks_data, 3), region_size, members.element_size(),
            torch.cuda.current_stream().cuda_stream)
    _check("xor_encode_regions", err, lib)
    launches += 1
    return out
