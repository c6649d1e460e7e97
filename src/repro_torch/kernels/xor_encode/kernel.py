"""Wrapper of the CUDA XOR parity encoder (``csrc/xor_encode.cu``), the
Hopper counterpart of ``encode_parities_pallas``
(``repro/kernels/xor_encode/kernel.py:37``).

The wrapper takes CUDA tensors only: it checks device, dtype, contiguity
and shape and raises on anything else, allocates the output, launches on
PyTorch's current stream and raises if the launch was refused. It never
falls back to the plain version. ``launches`` counts the launches made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_cuda_operand

launches = 0
LANES = (torch.int8, torch.int16, torch.int32)
N_MEMBERS = 3                          # MAX_SIBS + 1


def _lib() -> ctypes.CDLL:
    lib = build.library("xor_encode")
    if lib.xor_encode.argtypes is None:
        p = ctypes.c_void_p
        lib.xor_encode.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_longlong, p]
        lib.xor_encode.restype = ctypes.c_int
        lib.xor_encode_error_string.argtypes = [ctypes.c_int]
        lib.xor_encode_error_string.restype = ctypes.c_char_p
    return lib


def encode_parities_cuda(banks: torch.Tensor,
                         members: torch.Tensor) -> torch.Tensor:
    """(n_par, L, W) parity lanes on the card, bit-exact vs
    ``ref.encode_parities_plain``. ``banks`` (n_data, L, W) int8/int16/
    int32 lanes; ``members`` (n_par, 3) int32, -1 padded."""
    global launches
    fn = "encode_parities_cuda"
    lanes = banks.dtype
    if lanes not in LANES:
        raise TypeError(f"{fn}: banks must be int8/int16/int32 lanes, got "
                        f"{lanes}")
    if banks.dim() != 3 or members.dim() != 2:
        raise ValueError(f"{fn}: banks must be (n_data, L, W) and members "
                         "(n_par, 3)")
    nd = banks.shape[0]
    npar = members.shape[0]
    check_cuda_operand(fn, "banks", banks, lanes, banks.shape)
    check_cuda_operand(fn, "members", members, torch.int32,
                       (npar, N_MEMBERS))
    if banks.device != members.device:
        raise ValueError(f"{fn}: operands on different cards")
    out = torch.empty((npar,) + tuple(banks.shape[1:]), dtype=lanes,
                      device=banks.device)
    bank_bytes = banks[0].numel() * banks.element_size() if nd else 0
    if out.numel() == 0:
        return out
    if nd == 0:
        raise ValueError(f"{fn}: no data banks to encode")
    with torch.cuda.device(banks.device):
        lib = _lib()
        err = lib.xor_encode(banks.data_ptr(), members.data_ptr(),
                             out.data_ptr(), nd, npar, bank_bytes,
                             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("xor_encode kernel launch failed: "
                           + lib.xor_encode_error_string(err).decode())
    launches += 1
    return out
