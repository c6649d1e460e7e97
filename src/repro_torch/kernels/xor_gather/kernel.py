"""Wrappers of the CUDA coded row gather (``csrc/xor_gather.cu``), the
Hopper counterpart of ``gather_decode_pallas``
(``repro/kernels/xor_gather/kernel.py:108``): ``gather_decode_cuda`` reads
the seven request columns, ``gather_plan_cuda`` computes them from the
controller's read plan inside the kernel.

The wrappers take CUDA tensors only: they check device, dtype, layout and
shape and raise on anything else, allocate the output, launch on
PyTorch's current stream and raise if the launch was refused. They never
fall back to the plain version, and make no ATen op but the output's
allocation. ``launches`` counts the launches of both.
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
        lib.xor_gather_plan.argtypes = ([p] * 11 + [p, p] + [i, i, i, ll, i,
                                        ll, ll, i, i, i, i, i, p])
        lib.xor_gather_plan.restype = ctypes.c_int
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


def _point_stride(fn: str, name: str, t: torch.Tensor, dtype, shape,
                  batched: bool) -> int:
    """Check ``t`` (a CUDA tensor of ``dtype`` and ``shape``, contiguous
    within a point) and return its point stride in elements (0 for one
    point): a point-broadcast view such as an expanded bank-id row is taken
    as it is, without a copy."""
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: {name} is on {t.device}, not on the CUDA "
                         "card")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.numel() == 0:                     # nothing is read
        return 0
    inner = shape[1:] if batched else shape
    want = 1
    for k in range(len(inner) - 1, -1, -1):
        if inner[k] != 1 and t.stride(k + batched) != want:
            raise ValueError(f"{fn}: {name} is not contiguous within a "
                             "point")
        want *= inner[k]
    return t.stride(0) if batched and shape[0] > 1 else 0


def gather_plan_cuda(banks: torch.Tensor, parities: torch.Tensor,
                     cand_bank: torch.Tensor, cand_row: torch.Tensor,
                     mode: torch.Tensor, served: torch.Tensor,
                     region_slot: torch.Tensor, fresh_loc: torch.Tensor,
                     rs_active, region_size: int, opt_parity: torch.Tensor,
                     opt_sibs: torch.Tensor) -> torch.Tensor:
    """The served values of B points' read plans on the card, bit-exact vs
    ``ops.gather_plan_plain``: (B, N, *lanes) for candidates (B, N), banks
    (B, n_data, L, *lanes) and parities (B, n_par, Lp, *lanes) of int8,
    int16 or int32 lanes, ``region_slot`` (B, n_regions) and ``fresh_loc``
    (B, n_data, L) int32, ``mode`` int32 and ``served`` bool; one point
    drops the leading B everywhere. ``rs_active`` is an int or each point's
    (B,) int32/int64 tensor; ``opt_parity`` (n_data, MAX_OPTS) and
    ``opt_sibs`` (n_data, MAX_OPTS, 2) int32 or int64 tables. Each (B, ...)
    operand may broadcast over points (stride 0) but is contiguous within
    a point. N = 0 returns an empty tensor without a launch."""
    # not at import: the core package imports the system, and so this module
    from repro_torch.core.codes import MAX_OPTS

    global launches
    fn = "gather_plan_cuda"
    lanes = banks.dtype
    if lanes not in LANES:
        raise TypeError(f"{fn}: banks must be int8/int16/int32 lanes, got "
                        f"{lanes}")
    batched = cand_bank.dim() == 2
    lead = 1 if batched else 0
    if cand_bank.dim() not in (1, 2) or banks.dim() < 2 + lead or \
            parities.dim() != banks.dim():
        raise ValueError(f"{fn}: candidates must be (B, N) or (N,), banks "
                         "(B, n_data, L, ...) and parities (B, n_par, Lp, ...)"
                         " (no B for one point)")
    B = cand_bank.shape[0] if batched else 1
    n = cand_bank.shape[-1]
    pts = (B,) if batched else ()
    nd, rows = banks.shape[lead:lead + 2]
    npar, prows = parities.shape[lead:lead + 2]
    lane_shape = tuple(banks.shape[lead + 2:])
    n_regions = region_slot.shape[-1]
    strides = [_point_stride(fn, name, t, dt, pts + tuple(shape), batched)
               for name, t, dt, shape in (
                   ("cand_bank", cand_bank, torch.int32, (n,)),
                   ("cand_row", cand_row, torch.int32, (n,)),
                   ("mode", mode, torch.int32, (n,)),
                   ("served", served, torch.bool, (n,)),
                   ("region_slot", region_slot, torch.int32, (n_regions,)),
                   ("fresh_loc", fresh_loc, torch.int32, (nd, rows)))]
    for name, t, shape in (
            ("banks", banks, (nd, rows) + lane_shape),
            ("parities", parities, (npar, prows) + lane_shape)):
        per_point = 1
        for d in shape:
            per_point *= d
        if _point_stride(fn, name, t, lanes, pts + shape, batched) not in (
                0, per_point):
            raise ValueError(f"{fn}: {name} is not contiguous")
    tdt = opt_parity.dtype
    if tdt not in (torch.int32, torch.int64):
        raise TypeError(f"{fn}: code tables must be int32 or int64, got {tdt}")
    check_cuda_operand(fn, "opt_parity", opt_parity, tdt, (nd, MAX_OPTS))
    check_cuda_operand(fn, "opt_sibs", opt_sibs, tdt, (nd, MAX_OPTS, 2))
    rs_ptr, rs_bytes, rs_int = None, 0, 0
    if isinstance(rs_active, torch.Tensor):
        if rs_active.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{fn}: rs_active has dtype {rs_active.dtype}")
        check_cuda_operand(fn, "rs_active", rs_active, rs_active.dtype,
                           (B,))
        rs_ptr, rs_bytes = rs_active.data_ptr(), rs_active.element_size()
    else:
        rs_int = int(rs_active)
    operands = (banks, parities, cand_bank, cand_row, mode, served,
                region_slot, fresh_loc, opt_parity, opt_sibs)
    if len({t.device for t in operands}) != 1:
        raise ValueError(f"{fn}: operands on different cards")
    out = torch.empty(tuple(cand_bank.shape) + lane_shape, dtype=lanes,
                      device=banks.device)
    if out.numel() == 0:
        return out
    if 0 in (nd, rows, npar, prows, n_regions):
        raise ValueError(f"{fn}: empty banks {tuple(banks.shape)}, parities "
                         f"{tuple(parities.shape)} or region table")
    row_bytes = out.element_size()
    for w in lane_shape:
        row_bytes *= w
    with torch.cuda.device(banks.device):
        lib = _lib()
        err = lib.xor_gather_plan(
            banks.data_ptr(), parities.data_ptr(), cand_bank.data_ptr(),
            cand_row.data_ptr(), mode.data_ptr(), served.data_ptr(),
            region_slot.data_ptr(), fresh_loc.data_ptr(), rs_ptr,
            opt_parity.data_ptr(), opt_sibs.data_ptr(),
            (ctypes.c_longlong * 6)(*strides), out.data_ptr(), B, n, nd,
            rows, npar, prows, row_bytes, n_regions, region_size, rs_int,
            rs_bytes, opt_parity.element_size(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("xor_gather_plan kernel launch failed: "
                           + lib.xor_gather_error_string(err).decode())
    launches += 1
    return out
