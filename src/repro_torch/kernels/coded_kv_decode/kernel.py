"""Wrappers of the CUDA kernels of the coded KV decode datapath:

* ``gather_pool_cuda`` (``csrc/gather_pool.cu``), the Hopper counterpart of
  ``gather_pool_pallas`` (``repro/kernels/coded_kv_decode/kernel.py:182``);
  ``launches`` counts its launches;
* ``coded_kv_decode_cuda`` (``csrc/coded_kv_decode.cu``), the counterpart
  of ``coded_kv_decode_pallas`` (``kernel.py:102``); ``decode_launches``
  counts its launches.

A wrapper takes CUDA tensors only: it checks device, dtype, contiguity
and shape and raises on anything else, allocates the outputs and scratch,
launches on PyTorch's current stream and raises if the launch was refused.
It never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_cuda_operand

launches = 0
decode_launches = 0
# dtype codes of csrc/coded_kv_decode.cu, and the lanes of each value type
_DT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LANES_OF = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.float16: torch.int16}


# the split kernels of csrc/coded_kv_decode.cu, by their code there
KINDS = ("scalar", "tc", "general")


class Occupancy(NamedTuple):
    """The split kernel that serves a value type and shape on a card."""
    blocks: int        # its blocks that fit one SM
    smem: int          # its dynamic shared memory, bytes
    kind: str          # "tc", "scalar" (f32) or "general" (any width)
    groups: int        # head groups a kv head's query heads are cut into
    gb: int            # query heads a block takes
    gm: int            # template argument GM: most heads a block can take
    nv: int            # the f32 kernel's NV; the general one's vectors a
                       # thread (else 0)
    vec: int           # the general kernel's vector bytes W (else 0)
    cw: int            # the tensor-core kernel's warps a tile chain (else 0)
    lt: int            # the general kernel's most lanes a thread (else 0)
    slices: int        # column slices a row is cut into (1 but for the
                       # general kernel past 2,048 lanes a row)


# the Occupancy of (card, value dtype, H, Hkv, D)
_OCCUPANCY: Dict[Tuple[int, torch.dtype, int, int, int], Occupancy] = {}


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


def _decode_lib() -> ctypes.CDLL:
    lib = build.library("coded_kv_decode")
    if lib.coded_kv_decode.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.coded_kv_decode.argtypes = [p, i] + [p] * 10 + [i] * 11 + [
            ctypes.c_float, p]
        lib.coded_kv_decode.restype = ctypes.c_int
        ip = ctypes.POINTER(i)
        lib.coded_kv_decode_occupancy.argtypes = [i, i, i, i, ip]
        lib.coded_kv_decode_occupancy.restype = ctypes.c_int
        lib.coded_kv_decode_error_string.argtypes = [ctypes.c_int]
        lib.coded_kv_decode_error_string.restype = ctypes.c_char_p
    return lib


def decode_occupancy(value_dtype: torch.dtype, h: int, hkv: int, d: int,
                     device: torch.device) -> Occupancy:
    """The split kernel that serves this value type and shape over
    16-byte aligned banks, as the C dispatch picks it (the tensor-core one
    for bf16/f16 lanes at its widths, the scalar one for f32 lanes at its
    widths, the general one for every other width): its blocks per SM of
    ``device`` (CUDA's occupancy calculator), shared memory, head groups
    (one block per group), column slices and template arguments."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, value_dtype, h, hkv, d)
    if key not in _OCCUPANCY:
        info = (ctypes.c_int * len(Occupancy._fields))()
        with torch.cuda.device(idx):
            lib = _decode_lib()
            err = lib.coded_kv_decode_occupancy(
                _DT_CODE[value_dtype], h, hkv, d, info)
        if err != 0:
            raise RuntimeError(
                "coded_kv_decode occupancy query failed: "
                + lib.coded_kv_decode_error_string(err).decode())
        blocks, smem, kind, *rest = info
        _OCCUPANCY[key] = Occupancy(blocks, smem, KINDS[kind], *rest)
    return _OCCUPANCY[key]


def decode_splits(b: int, rows: int, n_pages: int, n_sms: int,
                  blocks_per_sm: int) -> int:
    """Page ranges per (sequence, grid row), chosen by the makespan: the
    count ``ns`` in 1..n_pages whose grid of ``b * rows * ns`` blocks takes
    the least waves x (pages a range + 1), a wave being ``n_sms *
    blocks_per_sm`` blocks (occupancy 0 counts as 1) and a block's fixed
    cost (its prologue, its partial and the merge's read of it) weighing
    as one page; ties go to the fewest ranges. Only counts that leave no
    range empty are taken (each range has ceil(n_pages / ns) pages, the
    last one what is left). ``rows`` is Hkv times the head groups times
    the column slices."""
    if n_pages == 0:
        return 1
    slots = n_sms * max(blocks_per_sm, 1)
    best = None
    for ns in range(1, n_pages + 1):
        per = -(-n_pages // ns)
        if -(-n_pages // per) != ns:           # a range would be empty
            continue
        cost = -(-(b * rows * ns) // slots) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, ns)
    return best[1]


def coded_kv_decode_cuda(
    q: torch.Tensor,           # (B, H, D) f32 / bf16 / f16
    k_banks: torch.Tensor,     # (B, NB, S, P, Hkv, D) int16/int32 lanes
    v_banks: torch.Tensor,
    k_par: torch.Tensor,       # (B, NB/2, S, P, Hkv, D)
    v_par: torch.Tensor,
    use_parity: torch.Tensor,  # (B, n_pages) int32, n_pages <= NB*S
    seq_len: torch.Tensor,     # (B,) int32
    value_dtype: torch.dtype,
) -> torch.Tensor:
    """Decode attention over per-sequence coded banks on the card: (B, H,
    D) in q's dtype, the function of ``ref.coded_kv_decode_plain``, at any
    head width D >= 1. bf16 and f16 lanes at D = 8, 16, 32, 64, 96, 128,
    160 or 256 run the tensor-core split kernel, f32 lanes at a row of 16,
    32, ..., 512 bytes or D = 160 the scalar one (the source's note says
    why), every other width in any lane type the general one; all are
    hand-written, and a merge kernel after the split kernel merges its
    page ranges (``decode_splits``). The first two need 16-byte aligned
    banks and parity, the general one lane-aligned ones. Any number of
    query heads per kv head: they are cut into head groups."""
    global decode_launches
    fn = "coded_kv_decode_cuda"
    if value_dtype not in _LANES_OF:
        raise TypeError(f"{fn}: value_dtype must be float32, bfloat16 or "
                        f"float16, got {value_dtype}")
    if q.dtype not in _DT_CODE:
        raise TypeError(f"{fn}: q must be float32, bfloat16 or float16, got "
                        f"{q.dtype}")
    if q.dim() != 3 or k_banks.dim() != 6 or use_parity.dim() != 2:
        raise ValueError(f"{fn}: need q (B, H, D), banks (B, NB, S, P, Hkv, "
                         "D) and use_parity (B, n_pages)")
    lanes = _LANES_OF[value_dtype]
    b, h, d = q.shape
    nb, slots, page, hkv = k_banks.shape[1:5]
    n_pages = use_parity.shape[1]
    if nb % 2 or h % hkv or n_pages > nb * slots:
        raise ValueError(f"{fn}: {nb} banks of {slots} slots, {h} heads on "
                         f"{hkv} kv heads, {n_pages} pages planned (need an "
                         "even NB, H % Hkv == 0, n_pages <= NB*S)")
    bank_shape = (b, nb, slots, page, hkv, d)
    par_shape = (b, nb // 2) + bank_shape[2:]
    check_cuda_operand(fn, "q", q, q.dtype, (b, h, d))
    check_cuda_operand(fn, "k_banks", k_banks, lanes, bank_shape)
    check_cuda_operand(fn, "v_banks", v_banks, lanes, bank_shape)
    check_cuda_operand(fn, "k_par", k_par, lanes, par_shape)
    check_cuda_operand(fn, "v_par", v_par, lanes, par_shape)
    check_cuda_operand(fn, "use_parity", use_parity, torch.int32,
                       (b, n_pages))
    check_cuda_operand(fn, "seq_len", seq_len, torch.int32, (b,))
    operands = (q, k_banks, v_banks, k_par, v_par, use_parity, seq_len)
    if len({t.device for t in operands}) != 1:
        raise ValueError(f"{fn}: operands on different cards")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    occ = decode_occupancy(value_dtype, h, hkv, d, q.device)
    if occ.kind != "general" and any(
            t.data_ptr() % 16 for t in (k_banks, v_banks, k_par, v_par)):
        raise ValueError(f"{fn}: banks and parity must be 16-byte aligned "
                         f"for the {occ.kind} kernel at D = {d}")
    rows = hkv * occ.groups * occ.slices
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    ns = decode_splits(b, rows, n_pages, n_sms, occ.blocks)
    g = h // hkv
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((b, hkv, ns, g), **f32)
    part_s = torch.empty((b, hkv, ns, g), **f32)
    part_acc = torch.empty((b, hkv, ns, g, d), **f32)
    with torch.cuda.device(q.device):
        lib = _decode_lib()
        err = lib.coded_kv_decode(
            q.data_ptr(), _DT_CODE[q.dtype], k_banks.data_ptr(),
            v_banks.data_ptr(), k_par.data_ptr(), v_par.data_ptr(),
            use_parity.data_ptr(), seq_len.data_ptr(), part_m.data_ptr(),
            part_s.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
            _DT_CODE[q.dtype], _DT_CODE[value_dtype], b, h, hkv, d, nb,
            slots, page, n_pages, ns, d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("coded_kv_decode kernel launch failed: "
                           + lib.coded_kv_decode_error_string(err).decode())
    decode_launches += 1
    return out
