"""Wrapper of the CUDA pool-gather kernel (``csrc/gather_pool.cu``), the
Hopper counterpart of ``gather_pool_pallas``
(``repro/kernels/coded_kv_decode/kernel.py:182``).

The wrapper takes CUDA tensors only: it checks device, dtype, contiguity
and shape and raises on anything else, allocates the outputs, launches on
PyTorch's current stream and raises if the launch was refused. It never
falls back to the plain version. ``launches`` counts the launches made.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_cuda_operand

launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.library("gather_pool")
    if lib.gather_pool.argtypes is None:
        p = ctypes.c_void_p
        lib.gather_pool.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_longlong,
                                    ctypes.c_longlong, p]
        lib.gather_pool.restype = ctypes.c_int
        lib.gather_pool_error_string.argtypes = [ctypes.c_int]
        lib.gather_pool_error_string.restype = ctypes.c_char_p
    return lib


def gather_pool_cuda(
    k_banks: torch.Tensor,     # (NB, S, P, Hkv, D) int16/int32/int8 lanes
    v_banks: torch.Tensor,
    k_par: torch.Tensor,       # (NG, S, P, Hkv, D), NG in {NB/2, 0}
    v_par: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) int32
    use_parity: torch.Tensor,  # (B, MP) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool-indirected coded page gather on the card: (B, MP, P, Hkv, D)
    K and V lanes, bit-exact vs ``ref.gather_pool_plain``."""
    global launches
    lanes = k_banks.dtype
    if lanes not in (torch.int16, torch.int32, torch.int8):
        raise TypeError(f"gather_pool_cuda: banks must be integer lanes, "
                        f"got {lanes}")
    if k_banks.dim() != 5:
        raise ValueError("gather_pool_cuda: banks must be (NB, S, P, Hkv, D)")
    nb, slots = k_banks.shape[:2]
    ng = k_par.shape[0]
    if ng not in (0, nb // 2) or (ng and nb % 2):
        raise ValueError(f"gather_pool_cuda: {ng} parity groups for {nb} "
                         "banks (need NB/2 for an even NB, or 0)")
    b, mp = page_table.shape
    fn = "gather_pool_cuda"
    check_cuda_operand(fn, "k_banks", k_banks, lanes, k_banks.shape)
    check_cuda_operand(fn, "v_banks", v_banks, lanes, k_banks.shape)
    check_cuda_operand(fn, "k_par", k_par, lanes,
                       (ng,) + tuple(k_banks.shape[1:]))
    check_cuda_operand(fn, "v_par", v_par, lanes,
                       (ng,) + tuple(k_banks.shape[1:]))
    check_cuda_operand(fn, "page_table", page_table, torch.int32, (b, mp))
    check_cuda_operand(fn, "use_parity", use_parity, torch.bool, (b, mp))
    if len({t.device for t in (k_banks, v_banks, k_par, v_par, page_table,
                               use_parity)}) != 1:
        raise ValueError("gather_pool_cuda: operands on different cards")
    out_shape = (b, mp) + tuple(k_banks.shape[2:])
    k_out = torch.empty(out_shape, dtype=lanes, device=k_banks.device)
    v_out = torch.empty_like(k_out)
    if b * mp == 0:
        return k_out, v_out
    page_bytes = k_banks[0, 0].numel() * k_banks.element_size()
    coded = ng > 0
    with torch.cuda.device(k_banks.device):
        lib = _lib()
        err = lib.gather_pool(
            k_banks.data_ptr(), v_banks.data_ptr(),
            k_par.data_ptr() if coded else None,
            v_par.data_ptr() if coded else None,
            page_table.data_ptr(),
            use_parity.data_ptr() if coded else None,
            k_out.data_ptr(), v_out.data_ptr(), nb, slots, page_bytes,
            b * mp, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("gather_pool kernel launch failed: "
                           + lib.gather_pool_error_string(err).decode())
    launches += 1
    return k_out, v_out
