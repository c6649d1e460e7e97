"""Wrapper of the CUDA coded row gather (``csrc/xor_gather.cu``), the
Hopper counterpart of ``gather_decode_pallas``
(``repro/kernels/xor_gather/kernel.py:108``).

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


def _lib() -> ctypes.CDLL:
    lib = build.library("xor_gather")
    if lib.xor_gather.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.xor_gather.argtypes = [p] * 10 + [i, ll, i, ll, ll, ll, p]
        lib.xor_gather.restype = ctypes.c_int
        lib.xor_gather_error_string.argtypes = [ctypes.c_int]
        lib.xor_gather_error_string.restype = ctypes.c_char_p
    return lib


def gather_decode_cuda(banks: torch.Tensor, parities: torch.Tensor,
                       bank: torch.Tensor, row: torch.Tensor,
                       mode: torch.Tensor, par: torch.Tensor,
                       prow: torch.Tensor, sib0: torch.Tensor,
                       sib1: torch.Tensor) -> torch.Tensor:
    """(N, W) lanes on the card, bit-exact vs ``ref.gather_decode_plain``.
    ``banks`` (n_data, L, W) and ``parities`` (n_par, Lp, W) are int8,
    int16 or int32 lanes; the seven columns are (N,) int32. N = 0 returns
    an empty (0, W) tensor without a launch."""
    global launches
    fn = "gather_decode_cuda"
    lanes = banks.dtype
    if lanes not in LANES:
        raise TypeError(f"{fn}: banks must be int8/int16/int32 lanes, got "
                        f"{lanes}")
    if banks.dim() != 3 or parities.dim() != 3:
        raise ValueError(f"{fn}: banks and parities must be (n, L, W)")
    nd, rows, w = banks.shape
    npar, prows = parities.shape[:2]
    n = bank.shape[0]
    check_cuda_operand(fn, "banks", banks, lanes, banks.shape)
    check_cuda_operand(fn, "parities", parities, lanes, (npar, prows, w))
    cols = (bank, row, mode, par, prow, sib0, sib1)
    for name, c in zip(("bank", "row", "mode", "par", "prow", "sib0",
                        "sib1"), cols):
        check_cuda_operand(fn, name, c, torch.int32, (n,))
    if len({t.device for t in (banks, parities) + cols}) != 1:
        raise ValueError(f"{fn}: operands on different cards")
    out = torch.empty((n, w), dtype=lanes, device=banks.device)
    if n == 0:
        return out
    if 0 in (nd, rows, npar, prows, w):
        raise ValueError(f"{fn}: empty banks {tuple(banks.shape)} or "
                         f"parities {tuple(parities.shape)}")
    with torch.cuda.device(banks.device):
        lib = _lib()
        err = lib.xor_gather(
            banks.data_ptr(), parities.data_ptr(),
            *(c.data_ptr() for c in cols), out.data_ptr(), nd, rows, npar,
            prows, w * banks.element_size(), n,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("xor_gather kernel launch failed: "
                           + lib.xor_gather_error_string(err).decode())
    launches += 1
    return out
