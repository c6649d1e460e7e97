"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card with ``nvcc``; without one it skips
(decided inside the ``cuda`` fixture, never at import). Run on the card:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu_kernels.py

(``--noconftest``: the repo's conftest imports JAX, which the card's
machine does not have; nothing here needs it.)
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
from repro_torch.kernels.coded_kv_decode.kernel import gather_pool_cuda
from repro_torch.kernels.coded_kv_decode.ref import gather_pool_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with -m gpu on the card")
    return torch.device("cuda")


def _pool_inputs(seed, *, nb, slots, page, hkv, d, b, mp, lanes, coded,
                 p_deg=0.4, p_hole=0.2):
    """Random lane bits, a page table with -1 holes and a degraded mix."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(lanes)
    shape = (nb, slots, page, hkv, d)
    ng = nb // 2 if coded else 0
    kb = rng.integers(info.min, info.max, size=shape, endpoint=True,
                      dtype=lanes)
    vb = rng.integers(info.min, info.max, size=shape, endpoint=True,
                      dtype=lanes)
    kp = rng.integers(info.min, info.max, size=(ng,) + shape[1:],
                      endpoint=True, dtype=lanes)
    vp = rng.integers(info.min, info.max, size=(ng,) + shape[1:],
                      endpoint=True, dtype=lanes)
    pt = rng.integers(0, nb * slots, size=(b, mp)).astype(np.int32)
    pt[rng.random((b, mp)) < p_hole] = -1
    up = rng.random((b, mp)) < p_deg
    return kb, vb, kp, vp, pt, up


CASES = {
    # name: (lanes, coded, nb, slots, page, hkv, d, b, mp, p_deg)
    "bf16_coded_serving_shape": (np.int16, True, 8, 64, 64, 2, 128, 8, 32, .4),
    "bf16_uncoded_serving_shape": (np.int16, False, 8, 64, 64, 2, 128, 8, 32,
                                   .4),
    "f32_coded": (np.int32, True, 8, 16, 16, 2, 64, 4, 12, .4),
    "odd_mp_all_degraded": (np.int16, True, 8, 8, 16, 2, 32, 3, 7, 1.0),
    "odd_mp_none_degraded": (np.int16, True, 4, 8, 16, 1, 32, 3, 7, 0.0),
    "tail_30_byte_pages": (np.int16, True, 8, 8, 3, 1, 5, 3, 5, .5),
    "tail_15_byte_pages_int8": (np.int8, True, 8, 8, 3, 1, 5, 3, 5, .5),
    "tail_12_byte_pages_uncoded": (np.int32, False, 8, 8, 3, 1, 1, 2, 9, .5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_pool_cuda_equals_plain(cuda, case):
    lanes, coded, nb, slots, page, hkv, d, b, mp, p_deg = CASES[case]
    arrays = _pool_inputs(7, nb=nb, slots=slots, page=page, hkv=hkv, d=d,
                          b=b, mp=mp, lanes=lanes, coded=coded, p_deg=p_deg)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = ckd_kernel.launches
    ko, vo = gather_pool_cuda(*args)
    torch.cuda.synchronize()
    assert ckd_kernel.launches == before + 1
    kr, vr = gather_pool_plain(*args)
    assert torch.equal(ko, kr) and torch.equal(vo, vr)
    # the same call on the CPU tensors gives the same bits
    kc, vc = gather_pool_plain(*[torch.from_numpy(a) for a in arrays])
    assert torch.equal(ko.cpu(), kc) and torch.equal(vo.cpu(), vc)


def _small(cuda):
    arrays = _pool_inputs(1, nb=8, slots=4, page=4, hkv=2, d=16, b=2, mp=3,
                          lanes=np.int16, coded=True)
    return [torch.from_numpy(a).to(cuda) for a in arrays]


def test_gather_pool_cuda_rejects_cpu_tensor(cuda):
    args = _small(cuda)
    args[0] = args[0].cpu()
    with pytest.raises(ValueError, match="not on the CUDA card"):
        gather_pool_cuda(*args)


def test_gather_pool_cuda_rejects_noncontiguous_bank(cuda):
    args = _small(cuda)
    args[1] = args[1].transpose(3, 4).contiguous().transpose(3, 4)
    assert not args[1].is_contiguous()
    with pytest.raises(ValueError, match="not contiguous"):
        gather_pool_cuda(*args)


def test_gather_pool_cuda_rejects_wrong_dtype(cuda):
    args = _small(cuda)
    args[4] = args[4].long()
    with pytest.raises(TypeError, match="dtype"):
        gather_pool_cuda(*args)
    args = _small(cuda)
    args[1] = args[1].view(torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        gather_pool_cuda(*args)


# ------------------------------------------------------- simulator kernels
from repro_torch.kernels.xor_encode import kernel as enc_kernel  # noqa: E402
from repro_torch.kernels.xor_encode.ref import (  # noqa: E402
    encode_parities_plain, encode_regions_plain)
from repro_torch.kernels.xor_gather import kernel as gat_kernel  # noqa: E402
from repro_torch.kernels.xor_gather.ref import (  # noqa: E402
    gather_decode_plain)

_LANE_NP = {"int8": np.int8, "int16": np.int16, "int32": np.int32}


def _gather_inputs(seed, lanes, n, w, n_data=8, rows=12, n_par=5, prows=6):
    """Random lane bits and columns covering every mode (-1 .. 7), siblings
    of -1 and indices past either end of their arrays."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(lanes)

    def bits(shape):
        return rng.integers(info.min, info.max, size=shape, endpoint=True,
                            dtype=lanes)

    cols = [rng.integers(lo, hi, n).astype(np.int32) for lo, hi in (
        (-2, n_data + 2), (-2, rows + 2), (-1, 8), (-1, n_par + 2),
        (-1, prows + 2), (-1, n_data + 1), (-1, n_data + 1))]
    return [bits((n_data, rows, w)), bits((n_par, prows, w))] + cols


@pytest.mark.parametrize("w", [1, 3, 5, 256])
@pytest.mark.parametrize("n", [0, 1, 7, 80, 1001])
@pytest.mark.parametrize("lanes", sorted(_LANE_NP))
def test_gather_decode_cuda_equals_plain(cuda, lanes, n, w):
    arrays = _gather_inputs(n * 7 + w, _LANE_NP[lanes], n, w)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = gat_kernel.launches
    out = gat_kernel.gather_decode_cuda(*args)
    torch.cuda.synchronize()
    assert gat_kernel.launches == before + (1 if n else 0)
    assert out.shape == (n, w) and out.dtype == args[0].dtype
    assert torch.equal(out, gather_decode_plain(*args))
    assert torch.equal(out.cpu(), gather_decode_plain(
        *[torch.from_numpy(a) for a in arrays]))


@pytest.mark.parametrize("rows,w", [(16, 1), (7, 3), (5, 5), (64, 256)])
@pytest.mark.parametrize("lanes", sorted(_LANE_NP))
@pytest.mark.parametrize("members", ["scheme_i", "scheme_iii", "pairs"])
def test_encode_parities_cuda_equals_plain(cuda, members, lanes, rows, w):
    from repro_torch.core.codes import get_tables
    if members == "pairs":
        table = np.array([[2 * g, 2 * g + 1, -1] for g in range(4)],
                         np.int32)
        n_data = 8
    else:
        t = get_tables(members, n_data=9 if members == "scheme_iii" else 8)
        table, n_data = t.par_members, t.n_data
    info = np.iinfo(_LANE_NP[lanes])
    banks = np.random.default_rng(rows * w).integers(
        info.min, info.max, size=(n_data, rows, w), endpoint=True,
        dtype=_LANE_NP[lanes])
    b, m = torch.from_numpy(banks).to(cuda), torch.from_numpy(table).to(cuda)
    before = enc_kernel.launches
    out = enc_kernel.encode_parities_cuda(b, m)
    torch.cuda.synchronize()
    assert enc_kernel.launches == before + 1
    assert torch.equal(out, encode_parities_plain(b, m))
    assert torch.equal(out.cpu(), encode_parities_plain(
        torch.from_numpy(banks), torch.from_numpy(table)))


def test_sim_kernel_wrappers_reject_bad_operands(cuda):
    args = [torch.from_numpy(a).to(cuda) for a in
            _gather_inputs(0, np.int32, 4, 2)]
    bad = list(args)
    bad[2] = bad[2].long()
    with pytest.raises(TypeError, match="dtype"):
        gat_kernel.gather_decode_cuda(*bad)
    bad = list(args)
    bad[0] = bad[0].cpu()
    with pytest.raises(ValueError, match="not on the CUDA card"):
        gat_kernel.gather_decode_cuda(*bad)
    banks = args[0]
    with pytest.raises(ValueError, match="shape"):
        enc_kernel.encode_parities_cuda(
            banks, torch.full((4, 2), -1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="not contiguous"):
        enc_kernel.encode_parities_cuda(
            banks, torch.full((3, 4), -1, dtype=torch.int32,
                              device=cuda).T)


# ------------------------------------------------------- coded_kv_decode
from repro_torch.kernels.coded_kv_decode import ops as ckd_ops  # noqa: E402
from repro_torch.kernels.coded_kv_decode.ref import (  # noqa: E402
    coded_kv_decode_plain)

_FLOAT = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _ulps(a, b):
    """Units in the last place between two 16-bit float tensors."""
    def key(t):
        u = t.view(torch.int16).long() & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u & 0x7FFF)
    return (key(a) - key(b)).abs()


def _decode_inputs(cuda, seed, *, value, q_dtype, b, t, h, hkv, d, nb, page,
                   cut=0, p_deg=0.4, stale=False):
    """Banks packed from seeded normals; parity fresh, or (``stale``) the
    odd sibling XOR another cache's even-bank page, which is not the
    pair's XOR, with degraded reads of even banks only; a plan of
    ``n_pages - cut`` pages; seq_len 0, a partial page, the full plan and
    past it."""
    rng = np.random.default_rng(seed)
    vd = _FLOAT[value]

    def normal(*shape, dtype=vd):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(dtype).to(cuda)

    k, v = normal(b, t, hkv, d), normal(b, t, hkv, d)
    kb, vb, kp, vp, n_pages = ckd_ops.pack_kv_banks(k, v, nb, page)
    if stale:
        kb2, vb2, _, _, _ = ckd_ops.pack_kv_banks(
            normal(b, t, hkv, d), normal(b, t, hkv, d), nb, page)
        kp, vp = kb[:, 1::2] ^ kb2[:, 0::2], vb[:, 1::2] ^ vb2[:, 0::2]
    n_plan = n_pages - cut
    up = rng.random((b, n_plan)) < p_deg
    if stale:       # a degraded odd-bank page would read garbage bits
        up &= (np.arange(n_plan) % nb) % 2 == 0
    up = torch.from_numpy(up.astype(np.int32))
    lens = [0, page + 3, n_plan * page, n_plan * page + 5]
    seq = torch.tensor([lens[i % 4] for i in range(b)], dtype=torch.int32)
    return (normal(b, h, d, dtype=_FLOAT[q_dtype]), kb, vb, kp, vp,
            up.to(cuda), seq.to(cuda), vd)


DECODE_CASES = {
    # name: (value, q dtype, b, t, h, hkv, d, nb, page, cut, p_deg, stale)
    "bf16_serving_g8": ("bf16", "bf16", 4, 512, 16, 2, 128, 8, 64, 0, .4,
                        False),
    "f32_bench_shape_g2": ("f32", "f32", 2, 128, 4, 2, 64, 4, 8, 0, .4,
                           False),
    "f16_g1": ("f16", "f16", 4, 256, 4, 4, 64, 4, 16, 0, .5, False),
    "bf16_d32_g4_fewer_pages": ("bf16", "bf16", 5, 256, 8, 2, 32, 8, 4, 13,
                                .5, False),
    "f32_d32_g16": ("f32", "f32", 4, 128, 32, 2, 32, 4, 8, 3, .5, False),
    "f32_d128_g3": ("f32", "f32", 4, 128, 6, 2, 128, 4, 8, 0, .5, False),
    "bf16_value_f32_q": ("bf16", "f32", 4, 256, 8, 2, 128, 8, 8, 0, .4,
                         False),
    "bf16_all_degraded_stale": ("bf16", "bf16", 4, 256, 8, 2, 64, 8, 8, 0,
                                1.0, True),
    "f32_stale_mixed": ("f32", "f32", 4, 128, 4, 2, 64, 4, 8, 0, .5, True),
    "bf16_one_page_per_block": ("bf16", "bf16", 1, 64, 2, 1, 64, 2, 2, 0,
                                .5, False),
    "bf16_g16": ("bf16", "bf16", 4, 256, 32, 2, 64, 8, 8, 0, .4, False),
    "bf16_d256": ("bf16", "bf16", 3, 256, 8, 2, 256, 4, 16, 0, .5, False),
    "bf16_d8": ("bf16", "bf16", 4, 128, 8, 2, 8, 4, 8, 0, .5, False),
    "bf16_d16": ("bf16", "bf16", 4, 128, 8, 2, 16, 4, 8, 0, .5, False),
    # f16 with G > 8: an f32 q takes the second (lo) q.K mma, and every
    # case the separate lo2(p) mma
    "f16_g16_f32_q": ("f16", "f32", 4, 256, 32, 2, 64, 8, 8, 0, .4, False),
    "f16_d16_g16_f32_q_stale": ("f16", "f32", 2, 128, 32, 2, 16, 4, 4, 0,
                                .5, True),
    # 29 pages of 4: seq_len 7 ends inside page 1 and token tile 0, the
    # full plan (116) inside page 28 and tile 14
    "bf16_p4_ends_mid_tile": ("bf16", "bf16", 5, 128, 16, 2, 64, 8, 4, 3,
                              .5, False),
    # stablelm-12b's head: D = 160, a 320-byte row of 20 chunks (bf16/f16)
    # or 640 bytes in 40 vectors (f32, 5 a thread)
    "bf16_d160_g4": ("bf16", "bf16", 4, 256, 8, 2, 160, 8, 16, 0, .4,
                     False),
    "f16_d160_g4": ("f16", "f16", 3, 256, 8, 2, 160, 4, 16, 0, .5, False),
    "f16_d160_g4_f32_q_stale": ("f16", "f32", 2, 128, 8, 2, 160, 4, 8, 0,
                                .5, True),
    "f32_d160_g4": ("f32", "f32", 3, 128, 8, 2, 160, 4, 8, 0, .5, False),
    # head groups at D = 160: 12 heads as two groups of 6 (tensor cores),
    # 3 heads as groups of 2 and 1 (f32)
    "bf16_d160_g12_two_groups": ("bf16", "bf16", 2, 128, 24, 2, 160, 4, 8,
                                 0, .5, False),
    "f32_d160_g3_uneven_groups": ("f32", "f32", 2, 128, 6, 2, 160, 4, 8, 0,
                                  .5, False),
    # granite-20b's MQA: 48 heads on one kv head, three groups of 16; an
    # f32 q on f16 lanes takes the lo(q) mma in every group
    "bf16_d128_g48": ("bf16", "bf16", 2, 256, 48, 1, 128, 8, 8, 0, .4,
                      False),
    "f16_g48_f32_q": ("f16", "f32", 2, 128, 48, 1, 128, 4, 8, 0, .5, False),
    "f32_g48": ("f32", "f32", 2, 128, 48, 1, 128, 4, 8, 0, .5, False),
    "bf16_g20_two_groups_stale": ("bf16", "bf16", 2, 128, 40, 2, 64, 4, 8,
                                  0, .5, True),
    # phi-3-vision-4.2b's head: D = 96, a 192-byte row of 12 chunks on the
    # tensor cores (its own swizzle), MHA (G = 1) and G = 8
    "bf16_d96_g1": ("bf16", "bf16", 4, 256, 8, 8, 96, 8, 16, 0, .4, False),
    "bf16_d96_g8": ("bf16", "bf16", 4, 256, 16, 2, 96, 8, 16, 0, .4, False),
    "f16_d96_g1": ("f16", "f16", 3, 128, 4, 4, 96, 4, 8, 0, .5, False),
    "f16_d96_g8_f32_q_stale": ("f16", "f32", 2, 128, 16, 2, 96, 4, 8, 0,
                               .5, True),
    # the general kernel: recurrentgemma-9b's MQA head in f32 lanes (D =
    # 256, G = 16, a 1,024-byte row in 16-byte vectors), rows that are no
    # whole number of 16-byte vectors (D = 100 bf16: 8-byte vectors; D =
    # 200 f16; D = 13: single lanes; D = 24 and 40, 48 and 80 bytes, once
    # refused), three head groups and a cut plan
    "f32_d256_g16": ("f32", "f32", 2, 128, 16, 1, 256, 4, 8, 0, .5, False),
    "bf16_d100": ("bf16", "bf16", 4, 256, 8, 2, 100, 8, 16, 0, .4, False),
    "f16_d200": ("f16", "f16", 2, 128, 8, 2, 200, 4, 8, 0, .5, False),
    "bf16_d13": ("bf16", "bf16", 4, 128, 8, 2, 13, 4, 8, 0, .5, False),
    "f32_d13_stale": ("f32", "f32", 2, 128, 4, 2, 13, 4, 8, 0, .5, True),
    "bf16_d24": ("bf16", "bf16", 3, 128, 4, 2, 24, 4, 8, 0, .5, False),
    "bf16_d40": ("bf16", "bf16", 3, 128, 8, 2, 40, 4, 8, 0, .5, False),
    "f32_d40": ("f32", "f32", 3, 128, 8, 2, 40, 4, 8, 0, .5, False),
    "bf16_d100_g48_f32_q_fewer_pages": ("bf16", "f32", 2, 128, 48, 1, 100,
                                        4, 8, 3, .5, False),
    # 16 heads x 1,600 lanes: the general kernel's large register tiling
    # (one head a block, up to 64 lanes a thread). Held in f32 (an f32 q):
    # at this width a bf16 q's output near zero rounds up to 4 ulps from
    # the f64 value (the plain version's 1), from f32 summation noise of
    # ~1e-6 against bf16 ulps of ~1e-7 there
    "bf16_d1600_g16_f32_q_acc_in_device_memory": (
        "bf16", "f32", 2, 64, 16, 1, 1600, 4, 8, 0, .5, False),
    # recurrentgemma-9b's local attention (D = 256, 16 heads on one kv
    # head): two head groups of 8, two warps a tile chain; 12 heads as two
    # groups of 6; an f32 q on f16 lanes over stale parity
    "bf16_d256_g16_two_groups": ("bf16", "bf16", 4, 256, 16, 1, 256, 8, 16,
                                 0, .4, False),
    "bf16_d256_g12_two_groups": ("bf16", "bf16", 2, 128, 12, 1, 256, 4, 8,
                                 0, .5, False),
    "f16_d256_g16_f32_q_stale": ("f16", "f32", 2, 128, 16, 1, 256, 4, 8, 0,
                                 .5, True),
    # hundreds of page ranges, merged by the merge kernel in chunks of 16:
    # the tensor-core, scalar and general kernels
    "bf16_d128_many_splits": ("bf16", "bf16", 3, 4096, 8, 1, 128, 8, 8, 0,
                              .4, False),
    "f32_d64_many_splits": ("f32", "f32", 3, 2048, 4, 1, 64, 8, 8, 0, .4,
                            False),
    "bf16_d100_many_splits": ("bf16", "bf16", 3, 2048, 8, 1, 100, 8, 8, 0,
                              .4, False),
    # rows wider than 2,048 lanes: the general kernel's column slices (2 at
    # D = 2,304 bf16, 3 at D = 4,100 f32), each slice's block summing the
    # whole row's scores; an f32 q as at D = 1,600
    "bf16_d2304_f32_q_column_slices": ("bf16", "f32", 2, 64, 4, 1, 2304, 4,
                                       8, 0, .5, False),
    "f32_d4100_column_slices": ("f32", "f32", 2, 64, 4, 2, 4100, 4, 8, 0,
                                .5, False),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_coded_kv_decode_cuda_equals_plain(cuda, case):
    """f32 within rtol = atol = 1e-5 with TF32 off; bf16/f16 within one
    ulp of the output type (the order of summation differs)."""
    value, qd, b, t, h, hkv, d, nb, page, cut, p_deg, stale = \
        DECODE_CASES[case]
    q, kb, vb, kp, vp, up, seq, vd = _decode_inputs(
        cuda, 11, value=value, q_dtype=qd, b=b, t=t, h=h, hkv=hkv, d=d,
        nb=nb, page=page, cut=cut, p_deg=p_deg, stale=stale)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = ckd_kernel.decode_launches
        out = ckd_kernel.coded_kv_decode_cuda(q, kb, vb, kp, vp, up, seq, vd)
        torch.cuda.synchronize()
        assert ckd_kernel.decode_launches == before + 1
        ref = coded_kv_decode_plain(q, kb, vb, kp, vp, up, seq, vd)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert out.dtype == q.dtype and out.shape == (b, h, d)
    assert torch.isfinite(out.float()).all()
    if q.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        assert int(_ulps(out, ref).max()) <= 1
    assert not out[seq == 0].any(), "seq_len 0 must read exact zeros"
    # the ops entry point dispatches CUDA tensors to the kernel
    before = ckd_kernel.decode_launches
    again = ckd_ops.coded_kv_decode(q, kb, vb, kp, vp, up.bool(), seq,
                                    value_dtype=vd)
    assert ckd_kernel.decode_launches == before + 1
    assert torch.equal(again, out)


def test_coded_kv_decode_cuda_rejects_what_it_does_not_take(cuda):
    q, kb, vb, kp, vp, up, seq, vd = _decode_inputs(
        cuda, 3, value="bf16", q_dtype="bf16", b=2, t=64, h=4, hkv=2, d=32,
        nb=4, page=8)
    fn = ckd_kernel.coded_kv_decode_cuda
    with pytest.raises(ValueError, match="not on the CUDA card"):
        fn(q, kb.cpu(), vb, kp, vp, up, seq, vd)
    with pytest.raises(TypeError, match="dtype"):
        fn(q, kb, vb, kp, vp, up.bool(), seq, vd)
    with pytest.raises(TypeError, match="dtype"):
        fn(q, kb, vb, kp, vp, up, seq, torch.float32)    # 16-bit lanes
    with pytest.raises(ValueError, match="pages"):
        fn(q, kb, vb, kp, vp, torch.zeros((2, 17), dtype=torch.int32,
                                          device=cuda), seq, vd)
    # the tensor-core kernel's widths need 16-byte aligned banks
    shifted = _shifted(kb)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(q, shifted, vb, kp, vp, up, seq, vd)


def _shifted(t):
    """``t``'s values in a contiguous tensor whose data starts one lane
    past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == t.element_size()
    return out


@pytest.mark.parametrize("value,q_dtype,d", [
    ("bf16", "bf16", 100), ("f16", "f16", 13), ("f32", "f32", 40),
    ("f16", "f16", 200), ("bf16", "f32", 1600), ("bf16", "f32", 2304)])
def test_coded_kv_decode_cuda_general_kernel_on_unaligned_banks(cuda, value,
                                                                q_dtype, d):
    """Banks that start one lane past a 16-byte boundary: the general
    kernel takes them with vectors of one lane (loaded straight into
    registers; D = 1,600 on the large register tiling and D = 2,304 in
    two column slices of it, with an f32 q as in ``DECODE_CASES``). Its
    result equals its own on aligned banks bit for bit where the vector
    width is the same there (D = 13: single lanes either way); otherwise
    the f32 results agree within rtol = atol = 1e-5 (wider vectors share
    a row's lanes out to the threads in another order, so the sums run in
    another order). The f32 result (an f32 q of the same values) is
    within rtol = atol = 1e-5 of the plain version's, and a 16-bit output
    is that result rounded, bit for bit, and within one ulp of the f64
    value. A 16-bit output is not held to one ulp of the plain version's
    own: near zero that one rounds two ulps from the f64 value at f16
    D = 200 on these inputs (seed 13)."""
    q, kb, vb, kp, vp, up, seq, vd = _decode_inputs(
        cuda, 13, value=value, q_dtype=q_dtype, b=3, t=128, h=8, hkv=2, d=d,
        nb=4, page=8)
    occ = ckd_kernel.decode_occupancy(vd, 8, 2, d, cuda)
    assert occ.kind == "general"
    assert occ.slices == (2 if d == 2304 else 1)
    banks = [_shifted(x) for x in (kb, vb, kp, vp)]
    q32 = q.float()
    out = ckd_kernel.coded_kv_decode_cuda(q, *banks, up, seq, vd)
    aligned = ckd_kernel.coded_kv_decode_cuda(q, kb, vb, kp, vp, up, seq, vd)
    out32 = ckd_kernel.coded_kv_decode_cuda(q32, *banks, up, seq, vd)
    aligned32 = ckd_kernel.coded_kv_decode_cuda(q32, kb, vb, kp, vp, up, seq,
                                                vd)
    torch.cuda.synchronize()
    if occ.vec == kb.element_size():
        assert torch.equal(out, aligned)
        assert torch.equal(out32, aligned32)
    torch.testing.assert_close(out32, aligned32, rtol=1e-5, atol=1e-5)
    ref32 = coded_kv_decode_plain(q32, kb, vb, kp, vp, up, seq, vd)
    torch.testing.assert_close(out32, ref32, rtol=1e-5, atol=1e-5)
    if q.dtype != torch.float32:
        assert torch.equal(out, out32.to(q.dtype))
        want = _decode_f64(q, kb, vb, kp, vp, up, seq, vd).to(q.dtype)
        assert int(_ulps(out, want).max()) <= 1
    assert not out[seq == 0].any(), "seq_len 0 must read exact zeros"


@pytest.mark.parametrize("value,d,kind,h", [
    ("bf16", 96, "tc", 16), ("f16", 96, "tc", 16), ("bf16", 256, "tc", 16),
    ("bf16", 256, "tc", 1), ("bf16", 256, "tc", 8), ("f16", 256, "tc", 12),
    ("bf16", 256, "tc", 48), ("bf16", 128, "tc", 48),
    ("bf16", 100, "general", 16), ("bf16", 13, "general", 16),
    ("f16", 200, "general", 16), ("f32", 128, "scalar", 16),
    ("f32", 160, "scalar", 16), ("f32", 256, "general", 16),
    ("f32", 40, "general", 16), ("bf16", 1600, "general", 16),
    ("bf16", 2304, "general", 16), ("f32", 4100, "general", 2)])
def test_coded_kv_decode_dispatch_by_width(cuda, value, d, kind, h):
    """Which split kernel takes a width and how it cuts h query heads on
    one kv head: the tensor-core one at its eight widths in 16-bit lanes
    (head groups of up to 16, 8 at D = 160 and 256, where two warps share
    a tile chain and two blocks fit an SM), the scalar one at its f32
    widths, the general one for the rest (its vectors the widest that
    divide the row; 8 lanes a thread and 8 heads a block up to 256 lanes,
    64 and one head beyond, in column slices of at most 32 x 64 lanes past
    2,048)."""
    occ = ckd_kernel.decode_occupancy(_FLOAT[value], h, 1, d, cuda)
    assert occ.kind == kind and occ.blocks >= 1
    assert occ.gb <= occ.gm and occ.groups == -(-h // occ.gm)
    assert occ.groups * occ.gb >= h > (occ.groups - 1) * occ.gb
    if kind == "tc":
        assert occ.gm == (8 if d >= 160 else 16 if h > 8 else 8)
        assert occ.cw == (2 if d == 256 else 1)
        if d == 256:
            assert occ.blocks >= 2
    else:
        assert occ.cw == 0
    if kind == "general":
        row = d * torch.tensor([], dtype=_FLOAT[value]).element_size()
        assert occ.vec == min(16, row & -row)
        assert occ.lt == (8 if d <= 256 else 64)
        assert occ.gm == (8 if d <= 256 else 1)
        lanes = occ.vec // torch.tensor([], dtype=_FLOAT[value]) \
            .element_size()
        assert occ.slices == -(-d // 2048)
        assert occ.slices * 32 * occ.nv * lanes >= d
        assert occ.nv * lanes <= occ.lt
    else:
        assert occ.vec == 0 and occ.lt == 0 and occ.slices == 1


@pytest.mark.parametrize("h,d", [(16, 128), (32, 64)])
def test_coded_kv_decode_cuda_bf16_q_equals_f32_q(cuda, h, d):
    """No degraded page, every sequence at full length: a bf16 q and the
    same values given as f32 give bit-identical f32 results (a 16-bit q
    has no lo part), so the bf16 output is the f32 one rounded."""
    q, kb, vb, kp, vp, up, _, vd = _decode_inputs(
        cuda, 5, value="bf16", q_dtype="bf16", b=3, t=512, h=h, hkv=2, d=d,
        nb=8, page=16)
    up = torch.zeros_like(up)
    seq = torch.full((3,), 512, dtype=torch.int32, device=cuda)
    out16 = ckd_kernel.coded_kv_decode_cuda(q, kb, vb, kp, vp, up, seq, vd)
    out32 = ckd_kernel.coded_kv_decode_cuda(q.float(), kb, vb, kp, vp, up,
                                            seq, vd)
    torch.cuda.synchronize()
    assert torch.equal(out32.to(torch.bfloat16).view(torch.int16),
                       out16.view(torch.int16))
    ref = coded_kv_decode_plain(q.float(), kb, vb, kp, vp, up, seq, vd)
    torch.testing.assert_close(out32, ref, rtol=1e-5, atol=1e-5)


def _decode_f64(q, kb, vb, kp, vp, up, seq, vd):
    """Decode attention over the logical K/V computed in f64."""
    b, nb, _, page, hkv, d = kb.shape
    n_pages = up.shape[1]
    t = torch.arange(n_pages, device=kb.device)
    bank, slot = t % nb, t // nb
    deg = up.bool()[..., None, None, None]

    def logical(banks, par):
        pages = torch.where(deg, banks[:, bank ^ 1, slot]
                            ^ par[:, bank // 2, slot], banks[:, bank, slot])
        return pages.reshape(b, n_pages * page, hkv, d).view(vd).double()

    k, v = logical(kb, kp), logical(vb, vp)
    g = q.shape[1] // hkv
    s = torch.einsum("bgkd,btkd->bgkt", q.double().reshape(b, g, hkv, d),
                     k) * d ** -0.5
    live = (torch.arange(k.shape[1], device=kb.device)[None, None, None]
            < seq[:, None, None, None])
    s = torch.where(live, s, float("-inf"))
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bgkt,btkd->bgkd", p, v)
    return (out / p.sum(-1).clamp(min=1e-30)[..., None]).reshape(b, g * hkv,
                                                                 d)


def test_coded_kv_decode_cuda_f16_g12_within_one_ulp_of_f64(cuda):
    """f16 lanes and an f16 q at G = 12 (the unpacked tile, the lo2(p)
    m16n8k8 product): the output within one ulp of the f64 value rounded.
    Held against f64, not the plain version: on these inputs the plain
    version's own f32 result rounds two ulps away from the kernel's while
    the kernel's stays within one ulp of the f64 value."""
    q, kb, vb, kp, vp, up, seq, vd = _decode_inputs(
        cuda, 11, value="f16", q_dtype="f16", b=3, t=128, h=24, hkv=2,
        d=128, nb=4, page=8, p_deg=.5)
    out = ckd_kernel.coded_kv_decode_cuda(q, kb, vb, kp, vp, up, seq, vd)
    torch.cuda.synchronize()
    want = _decode_f64(q, kb, vb, kp, vp, up, seq, vd)
    assert int(_ulps(out, want.to(torch.float16)).max()) <= 1
    assert not out[seq == 0].any(), "seq_len 0 must read exact zeros"


@pytest.mark.parametrize("case", ["bf16_serving_g8", "bf16_d96_g1",
                                  "bf16_d256_g16_two_groups",
                                  "bf16_d128_many_splits",
                                  "f32_d64_many_splits", "f32_d256_g16",
                                  "bf16_d100_many_splits",
                                  "bf16_d2304_f32_q_column_slices"])
def test_coded_kv_decode_cuda_kernels_of_a_call(cuda, case, tmp_path):
    """A call launches the split kernel and the merge kernel after it, and
    nothing else: in a torch.profiler trace of the second of two calls,
    two launch calls on the host and at most two kernel records (a trace
    can drop one), each of them one of those kernels; the two calls agree
    bit for bit."""
    import json
    from torch.profiler import ProfilerActivity, profile

    value, qd, b, t, h, hkv, d, nb, page, cut, p_deg, stale = \
        DECODE_CASES[case]
    q, kb, vb, kp, vp, up, seq, vd = _decode_inputs(
        cuda, 11, value=value, q_dtype=qd, b=b, t=t, h=h, hkv=hkv, d=d,
        nb=nb, page=page, cut=cut, p_deg=p_deg, stale=stale)
    occ = ckd_kernel.decode_occupancy(vd, h, hkv, d, cuda)
    ns = ckd_kernel.decode_splits(
        b, hkv * occ.groups * occ.slices, up.shape[1],
        torch.cuda.get_device_properties(cuda).multi_processor_count,
        occ.blocks)
    if "many_splits" in case:
        assert ns > 1
    first = ckd_kernel.coded_kv_decode_cuda(q, kb, vb, kp, vp, up, seq, vd)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = ckd_kernel.coded_kv_decode_cuda(q, kb, vb, kp, vp, up, seq,
                                                vd)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    launches = [e["name"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in e.get("name", "")]
    assert len(launches) == 2, launches
    assert len(kernels) <= 2, kernels
    assert all(re.search(r"kv_decode_(tc|split|general|combine)_kernel", k)
               for k in kernels), kernels
    assert torch.equal(again, first)


def test_coded_kv_decode_cuda_empty_batch_and_plan(cuda):
    q, kb, vb, kp, vp, up, seq, vd = _decode_inputs(
        cuda, 4, value="f32", q_dtype="f32", b=2, t=64, h=4, hkv=2, d=32,
        nb=4, page=8)
    out = ckd_kernel.coded_kv_decode_cuda(q, kb, vb, kp, vp, up[:, :0],
                                          seq, vd)
    torch.cuda.synchronize()
    assert not out.any(), "a plan of no page reads zeros"
    before = ckd_kernel.decode_launches
    out = ckd_kernel.coded_kv_decode_cuda(q[:0], kb[:0], vb[:0], kp[:0],
                                          vp[:0], up[:0], seq[:0], vd)
    assert out.shape == (0, 4, 32) and ckd_kernel.decode_launches == before


# ----------------------------------------------- node replacement, devices
@pytest.mark.parametrize("first,second", [("cuda", "cpu"), ("cpu", "cuda")])
def test_snapshot_restores_on_the_other_device(cuda, first, second):
    """A snapshot taken mid-stream on one device restores on the other and
    both nodes finish with the same tokens and the same planes (reduced
    qwen2.5-3b at f32, TF32 off)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.runtime.server import Request, ServeConfig, Server

    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), kv_page=4,
                              compute_dtype="float32")
    params = lm.init_params(cfg, seed=1, device="cpu")
    sc = ServeConfig(n_slots=3, max_prompt=8, max_seq=24, max_new_tokens=5,
                     telemetry=True)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=[int(x) for x in rng.integers(
        1, 256, size=3 + i % 4)]) for i in range(5)]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a = Server(cfg, sc, params, device=first)
        for r in reqs:
            a.submit(r)
        for _ in range(3):
            a.step()
        snap = a.snapshot()
        b = Server(cfg, sc, params, device=second)
        b.restore_snapshot(snap)
        b.queue = [Request(rid=r.rid, prompt=list(r.prompt),
                           out=list(r.out)) for r in a.queue]
        moved = [r for r in b.slots if r] + b.queue
        for srv in (a, b):
            srv.run_until_drained()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    by_rid = {r.rid: r.out for r in reqs}
    assert moved and all(r.out == by_rid[r.rid] for r in moved)
    assert a.serve_snapshot().as_dict() == b.serve_snapshot().as_dict()
    assert b.cache["pool"].k_banks.device.type == second


# ------------------------------------------------- streamed trace replay
def _stream_systems(seed=0, n_cores=4, length=24, n_rows=64):
    """The same system on the card and on the CPU, and a seeded trace on
    each (8 banks x 64 rows, scheme_i, alpha 0.25, r 0.125, select 8)."""
    from repro_torch.core import codes, state, system

    rng = np.random.default_rng(seed)
    cols = (rng.integers(0, 8, (n_cores, length)).astype(np.int32),
            rng.integers(0, n_rows, (n_cores, length)).astype(np.int32),
            rng.random((n_cores, length)) < 0.45,
            rng.integers(1, 1 << 20, (n_cores, length)).astype(np.int32),
            rng.random((n_cores, length)) < 0.9)
    t = codes.get_tables("scheme_i")
    p = state.make_params(t, n_rows=n_rows, alpha=0.25, r=0.125, recode_cap=8)
    out = {}
    for dev in ("cuda", "cpu"):
        sys_ = system.CodedMemorySystem(
            t, p, n_cores=n_cores, device=dev,
            tunables=state.make_tunables(select_period=8))
        out[dev] = (sys_, system.Trace(*(torch.from_numpy(c).to(dev)
                                         for c in cols)))
    return out


def _same_sim_state(a, b):
    leaves = list(zip(a.mem, b.mem)) + [(a.core_ptr, b.core_ptr),
                                        (a.done_cycle, b.done_cycle)]
    return all((x is None and y is None) or (
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()))
        for x, y in leaves)


@pytest.mark.parametrize("exit_", ["starved", "quiescent", "budget"])
def test_run_chunk_on_the_card_equals_the_cpu(cuda, exit_):
    """One ``run_chunk`` call from a fresh state, on the card and on the
    CPU, leaves every leaf equal, for each way out of its loop; on the card
    the read datapath launches ``xor_gather``."""
    from repro_torch.core.state import INT32_MAX
    from repro_torch.core.system import quiescent
    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.traces import chunk_bound

    systems = _stream_systems()
    chunk_len, more, budget = {
        "starved": (6, True, None), "quiescent": (24, False, None),
        "budget": (24, False, 9)}[exit_]
    got = {}
    launched = gk.launches
    for dev, (sys_, tr) in systems.items():
        chunk = type(tr)(*(x[:, :chunk_len].contiguous() for x in tr))
        se = torch.full((sys_.n_cores,), INT32_MAX if more else chunk_len,
                        dtype=torch.int32, device=dev)
        n = budget if budget is not None else chunk_bound(sys_, chunk_len)
        got[dev] = sys_.run_chunk(sys_.init(), chunk, se, n)
    assert gk.launches > launched
    st = got["cpu"]
    assert _same_sim_state(got["cuda"], st)
    starved = bool((st.core_ptr >= chunk_len).any()) and more
    assert (starved, bool(quiescent(st)), int(st.mem.cycle) == budget) == (
        exit_ == "starved", exit_ == "quiescent", exit_ == "budget")


@pytest.mark.parametrize("chunk_len", [5, 16])
def test_stream_replay_on_the_card_equals_the_cpu(cuda, chunk_len):
    """A short streamed replay on the card equals the CPU's (windows and
    final state included) and the card's single-shot run."""
    from repro_torch.core.system import drain_bound
    from repro_torch.traces import stream_replay, strip_windows

    systems = _stream_systems(seed=3)
    got = {dev: stream_replay(sys_, tr, chunk_len=chunk_len,
                              return_state=True)
           for dev, (sys_, tr) in systems.items()}
    res = {dev: r for dev, (r, _) in got.items()}
    assert res["cuda"] == res["cpu"] and res["cuda"].completed
    assert _same_sim_state(got["cuda"][1], got["cpu"][1])
    sys_, tr = systems["cuda"]
    assert strip_windows(res["cuda"]) == sys_.run(tr, drain_bound(4, 24))


# ------------------------------------------------------- the point axis
@pytest.mark.parametrize("B", [1, 3, 13])
def test_batched_sim_kernels_equal_plain(cuda, B):
    """The simulator kernels on a flattened batch of B points at the
    simulator's shapes (8 banks x 320 rows, scheme_i's 12 parities of 5
    slots x 16 rows, N = 80 requests a point, one region encode a point),
    through the wrappers, against the plain versions: one launch each."""
    from repro_torch.core.codes import get_tables
    from repro_torch.kernels.xor_encode import ops as enc_ops
    from repro_torch.kernels.xor_gather import ops as g_ops

    rng = np.random.default_rng(B)
    nd, rows, npar, prows, n = 8, 320, 12, 80, 80
    info = np.iinfo(np.int32)
    banks = torch.from_numpy(rng.integers(
        info.min, info.max, (B, nd, rows, 1), endpoint=True,
        dtype=np.int32)).to(cuda)
    pars = torch.from_numpy(rng.integers(
        info.min, info.max, (B, npar, prows, 1), endpoint=True,
        dtype=np.int32)).to(cuda)
    pt = np.arange(B)[:, None]
    sib = rng.integers(-1, nd, (2, B, n))
    cols = [rng.integers(0, nd, (B, n)) + pt * nd, rng.integers(0, rows,
                                                                (B, n)),
            rng.integers(-1, 7, (B, n)), rng.integers(0, npar, (B, n))
            + pt * npar, rng.integers(0, prows, (B, n)),
            np.where(sib[0] >= 0, sib[0] + pt * nd, -1),
            np.where(sib[1] >= 0, sib[1] + pt * nd, -1)]
    cols = g_ops.PlanColumns(*(torch.from_numpy(c.reshape(-1).astype(
        np.int32)).to(cuda) for c in cols))
    g0, e0 = gat_kernel.launches, enc_kernel.launches
    got = g_ops.gather_decode(banks, pars, cols)
    members = get_tables("scheme_i").par_members
    region = banks[:, :, 16:32].contiguous()
    enc = enc_ops.encode_parities(region, members)
    torch.cuda.synchronize()
    assert (gat_kernel.launches - g0, enc_kernel.launches - e0) == (1, 1)
    assert torch.equal(got, gather_decode_plain(
        banks.flatten(0, 1), pars.flatten(0, 1), *cols))
    m = enc_ops.member_table(members, cuda)
    for b in range(B):
        assert torch.equal(enc[b], encode_parities_plain(region[b], m))


def test_run_batch_on_the_card_equals_the_cpu(cuda):
    """A small α x r sweep (two batches, one with traced geometry) through
    ``run_points`` on the card and on the CPU: every SimResult field and
    every final state leaf equal; both kernels launched on the card."""
    from repro_torch.sweep import SweepPoint, grid, run_points

    pts = grid(SweepPoint(scheme="scheme_i", n_rows=64, n_cores=3,
                          length=16, select_period=4),
               alpha=(0.25, 0.5, 1.0), r=(0.125, 0.25), seed=(0, 1))
    g0, e0 = gat_kernel.launches, enc_kernel.launches
    card, card_st = run_points(pts, device=cuda, return_state=True)
    assert gat_kernel.launches > g0 and enc_kernel.launches > e0
    cpu, cpu_st = run_points(pts, device="cpu", return_state=True)
    assert card == cpu and sum(r.switches for r in card) > 0
    for a, b in zip(card_st, cpu_st):
        assert _same_sim_state(a, b)



@pytest.mark.parametrize("scheme", ["scheme_ii", "scheme_iii"])
def test_sim_kernels_on_live_batched_states(cuda, scheme, monkeypatch):
    """Both sim kernels against their plain versions on the live inputs of
    a scheme II / scheme III sweep on the card whose α x r points share one
    batch (traced geometry): every ``xor_gather`` and ``xor_encode`` launch
    of the run is recorded with its operands and held against the plain
    version on them. The plans serve degraded reads, and scheme III's XOR
    two siblings."""
    from repro_torch.core.controller import MODE_OPT0, MODE_REDIRECT
    from repro_torch.kernels.xor_encode import ops as enc_ops
    from repro_torch.kernels.xor_gather import ops as g_ops
    from repro_torch.sweep import SweepPoint, grid, partition, run_points
    from repro_torch.sweep.engine import mixed_geometry

    def record(store, launch):
        def recorded(*args):
            out = launch(*args)
            store.append(([a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args], out.clone()))
            return out
        return recorded

    gathers, encodes = [], []
    monkeypatch.setattr(g_ops, "gather_plan_cuda",
                        record(gathers, g_ops.gather_plan_cuda))
    monkeypatch.setattr(enc_ops, "encode_regions_cuda",
                        record(encodes, enc_ops.encode_regions_cuda))
    pts = grid(SweepPoint(scheme=scheme, n_rows=64, n_cores=8, length=32,
                          write_frac=0.1, select_period=4),
               alpha=(0.25, 0.5), r=(0.125, 0.25))
    assert len(partition(pts)) == 1 and mixed_geometry(pts)
    res = run_points(pts, device=cuda)
    assert len(gathers) >= 10 and len(encodes) >= 1
    assert sum(r.switches for r in res) >= 1
    degraded = two_sibling = 0
    for args, out in gathers:
        assert torch.equal(out, g_ops.gather_plan_plain(*args))
        cols = g_ops.gather_plan_columns(*args)
        opt = (cols.mode >= MODE_OPT0) & (cols.mode < MODE_REDIRECT)
        degraded += int(opt.sum())
        two_sibling += int((opt & (cols.sib0 >= 0)
                            & (cols.sib1 >= 0)).sum())
    for args, out in encodes:
        assert torch.equal(out, encode_regions_plain(*args))
    assert degraded > 0
    assert (two_sibling > 0) == (scheme == "scheme_iii")


# ------------------------------------------------------------ bank faults
def test_sim_kernels_on_a_faulted_batch(cuda, monkeypatch):
    """A scheme III batch with bank faults (no plan, a dead bank, a bank
    that fails and rebuilds, a dead bank with a stuttering port) at α < 1,
    64 rows x 32 requests a core, on the card: every ``xor_gather`` and
    ``xor_encode`` launch is recorded with its operands and held against
    the plain version on them; the plans serve reads degraded because
    their bank is down (parity ^ two siblings), and the results and final
    states equal the CPU's."""
    from repro_torch.core.controller import MODE_OPT0, MODE_REDIRECT
    from repro_torch.kernels.xor_encode import ops as enc_ops
    from repro_torch.kernels.xor_gather import ops as g_ops
    from repro_torch.sweep import SweepPoint, partition, run_points

    def record(store, launch):
        def recorded(*args):
            out = launch(*args)
            store.append(([a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args], out.clone()))
            return out
        return recorded

    specs = [(), (("bank", 0, 0),), (("bank", 4, 5, 30),),
             (("bank", 2, 0), ("stutter", 12, 3, 1))]
    base = SweepPoint(scheme="scheme_iii", n_data=9, n_banks=9, n_rows=64,
                      n_cores=8, length=32, write_frac=0.3, alpha=0.25,
                      r=0.125, select_period=4)
    pts = [base.replace(faults=sp, alpha=a, seed=k)
           for k, sp in enumerate(specs) for a in (0.25, 0.5)]
    assert [len(b) for b in partition(pts)] == [2, 6]
    gathers, encodes = [], []
    monkeypatch.setattr(g_ops, "gather_plan_cuda",
                        record(gathers, g_ops.gather_plan_cuda))
    monkeypatch.setattr(enc_ops, "encode_regions_cuda",
                        record(encodes, enc_ops.encode_regions_cuda))
    card, card_st = run_points(pts, device=cuda, return_state=True)
    assert len(gathers) >= 10 and len(encodes) >= 1
    two_sibling = 0
    for args, out in gathers:
        assert torch.equal(out, g_ops.gather_plan_plain(*args))
        cols = g_ops.gather_plan_columns(*args)
        opt = (cols.mode >= MODE_OPT0) & (cols.mode < MODE_REDIRECT)
        two_sibling += int((opt & (cols.sib0 >= 0)
                            & (cols.sib1 >= 0)).sum())
    for args, out in encodes:
        assert torch.equal(out, encode_regions_plain(*args))
    assert two_sibling > 0
    assert sum(r.fault_degraded_reads for r in card) > 0
    cpu, cpu_st = run_points(pts, device="cpu", return_state=True)
    assert card == cpu
    for a, b in zip(card_st, cpu_st):
        assert _same_sim_state(a._replace(mem=a.mem._replace(fault=None)),
                               b._replace(mem=b.mem._replace(fault=None)))
        fa, fb = a.mem.fault, b.mem.fault
        assert (fa is None) == (fb is None)
        assert fa is None or all(torch.equal(x.cpu(), y.cpu())
                                 for x, y in zip(fa, fb))


# ------------------------------------------------- the fused sim entries
def _plan_operands(cuda, seed, B, scheme, n=80, rows=320, rs=16, n_slots=5,
                   lanes=(), batched=True, traced=False, table=torch.int64):
    """``gather_plan_cuda``'s operands for B points: every mode (-1 .. 7),
    served at random, candidate banks and rows past either end, holders
    past the last parity, slots past the last one (all clamped), random
    int32 lane bits; the candidates' banks broadcast over points (stride
    0), as the system's bank-id row is; ``traced``: each point's region
    size as a (B,) int32 tensor."""
    from repro_torch.core.codes import get_tables

    t = get_tables(scheme)
    nd, npar = t.n_data, t.par_members.shape[0]
    rng = np.random.default_rng(seed)
    n_regions = rows // (2 if traced else rs)

    def ints(lo, hi, shape, dt=np.int32):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dt)).to(
            cuda)

    info = np.iinfo(np.int32)
    args = [ints(info.min, info.max, (B, nd, rows) + lanes),
            ints(info.min, info.max, (B, npar, n_slots * rs) + lanes),
            ints(-2, nd + 2, (1, n)).expand(B, n), ints(-2, rows + 2, (B, n)),
            ints(-1, 8, (B, n)), ints(0, 2, (B, n), np.bool_),
            ints(-1, n_slots + 1, (B, n_regions)),
            ints(0, npar + 3, (B, nd, rows)),
            ints(1, rs + 1, (B,)) if traced else rs, rs,
            torch.from_numpy(t.opt_parity).to(cuda, table),
            torch.from_numpy(t.opt_sibs).to(cuda, table)]
    if not batched:                       # one point: no leading B
        args[:9] = [a[0] if isinstance(a, torch.Tensor) else a
                    for a in args[:9]]
    return args


@pytest.mark.parametrize("lanes", [(), (3,), (256,)])
@pytest.mark.parametrize("B", [1, 8, 13])
@pytest.mark.parametrize("scheme", ["scheme_i", "scheme_iii"])
def test_gather_plan_cuda_equals_plain(cuda, scheme, B, lanes):
    """The plan-fed gather against ``gather_decode_plain`` of the plan's
    columns, bit for bit: every mode, clamped out-of-range ids, 4-, 12- and
    1,024-byte rows, one launch; at B = 1 also the (N,) plan of one point,
    and at B = 8 each point's own traced region size."""
    from repro_torch.kernels.xor_gather import ops as g_ops

    cases = [dict()]
    if B == 1:
        cases.append(dict(batched=False))
    if B == 8:
        cases.append(dict(traced=True, table=torch.int32))
    for kw in cases:
        args = _plan_operands(cuda, B * 7 + len(lanes), B, scheme,
                              lanes=lanes, **kw)
        before = gat_kernel.launches
        out = gat_kernel.gather_plan_cuda(*args)
        torch.cuda.synchronize()
        assert gat_kernel.launches == before + 1
        assert out.shape == tuple(args[2].shape) + lanes
        assert torch.equal(out, g_ops.gather_plan_plain(*args)), kw
        if B > 1:                             # -1 .. 6 all served
            cols = g_ops.gather_plan_columns(*args)
            modes = torch.bincount(cols.mode.long() + 1, minlength=9)
            assert bool((modes[:8] > 0).all())


def test_gather_plan_cuda_empty_plan(cuda):
    args = _plan_operands(cuda, 0, 3, "scheme_i", n=0)
    before = gat_kernel.launches
    out = gat_kernel.gather_plan_cuda(*args)
    assert out.shape == (3, 0) and gat_kernel.launches == before


def _region_operands(cuda, seed, B, scheme, lanes=(), table=torch.int64):
    """Banks (B, n_data, 320, *lanes) and parities (B, n_par, 80, *lanes)
    of random bits, and completing encodes of about half the points:
    regions past the last row, slots past the last one and -1, traced
    region sizes below the allocation's 16."""
    from repro_torch.core.codes import get_tables

    t = get_tables(scheme)
    rng = np.random.default_rng(seed)
    info = np.iinfo(np.int32)
    nd, npar = t.n_data, t.par_members.shape[0]
    banks = torch.from_numpy(rng.integers(
        info.min, info.max, (B, nd, 320) + lanes, dtype=np.int32)).to(cuda)
    pars = torch.from_numpy(rng.integers(
        info.min, info.max, (B, npar, 80) + lanes, dtype=np.int32)).to(cuda)
    pts = rng.permutation(B)[:max(1, B // 2)]
    done = [(int(b), int(rng.integers(0, 24)), int(rng.integers(-1, 7)),
             int(rng.choice([16, 16, 8, 3]))) for b in pts]
    return (banks, pars, torch.from_numpy(t.par_members).to(cuda, table),
            torch.tensor(done, dtype=torch.int32, device=cuda), 16)


@pytest.mark.parametrize("lanes", [(), (5,)])
@pytest.mark.parametrize("B", [1, 8, 13])
@pytest.mark.parametrize("scheme", ["scheme_i", "scheme_iii"])
def test_encode_regions_cuda_equals_plain(cuda, scheme, B, lanes):
    """The region encode written into a copy of the parity state against
    ``encode_regions_plain``, bit for bit, the input state untouched; one
    launch (int32 member table at B = 8)."""
    args = _region_operands(cuda, B + len(lanes), B, scheme, lanes,
                            torch.int32 if B == 8 else torch.int64)
    before_state = args[1].clone()
    before = enc_kernel.launches
    out = enc_kernel.encode_regions_cuda(*args)
    torch.cuda.synchronize()
    assert enc_kernel.launches == before + 1
    assert torch.equal(args[1], before_state)
    assert torch.equal(out, encode_regions_plain(*args))


@pytest.mark.parametrize("B", [1, 8, 13])
@pytest.mark.parametrize("members", ["scheme_i", "scheme_iii", "pairs",
                                     "wide"])
def test_encode_parities_cuda_batched_equals_plain(cuda, members, B):
    """Banks (B, n_data, L, W) and the one-point member table (int64, as
    the code tables hold it): each point XORs its own banks, one launch;
    "wide" has 20 banks, past the registers body's 16."""
    from repro_torch.core.codes import get_tables

    if members == "pairs":
        table, nd = np.array([[2 * g, 2 * g + 1, -1] for g in range(4)]), 8
    elif members == "wide":
        table, nd = np.array([[k, (k + 7) % 20, 25] for k in range(10)]), 20
    else:
        t = get_tables(members)
        table, nd = t.par_members, t.n_data
    info = np.iinfo(np.int32)
    banks = torch.from_numpy(np.random.default_rng(B).integers(
        info.min, info.max, (B, nd, 48, 3), dtype=np.int32)).to(cuda)
    m = torch.from_numpy(table.astype(np.int64)).to(cuda)
    before = enc_kernel.launches
    out = enc_kernel.encode_parities_cuda(banks, m)
    torch.cuda.synchronize()
    assert enc_kernel.launches == before + 1
    assert torch.equal(out, encode_parities_plain(banks, m))


class _AtenOps:
    """Every ATen op dispatched inside the block, by name."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        ops = self.ops = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(str(func))
                return func(*args, **(kwargs or {}))

        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


@pytest.mark.parametrize("B", [1, 8])
def test_read_values_is_one_launch_and_no_other_op(cuda, B):
    """A busy read-branch cycle's ``_read_values`` on the card, B points of
    Fig 18's scheme_i alpha 0.25 (seeds 0..B-1): one ``xor_gather`` launch
    and no ATen op but its output's allocation; the values equal the plain
    version's. Then the completion datapath's ``encode_regions`` makes at
    most the block copy, the clone and the allocation."""
    from repro_torch.core import controller as ctl
    from repro_torch.core.state import active_geometry
    from repro_torch.kernels.xor_encode import ops as enc_ops
    from repro_torch.kernels.xor_gather import ops as g_ops
    from repro_torch.sweep import SweepPoint, build_trace, stack_traces
    from repro_torch.sweep.engine import (mixed_geometry, stack_tunables,
                                          system_for)
    from repro_torch.sweep.grid import batch_geometry_alloc

    pts = [SweepPoint(scheme="scheme_i", alpha=0.25, r=0.05, n_rows=320,
                      n_cores=8, length=96, select_period=32, seed=k)
           for k in range(B)]
    sys_ = system_for(pts[0], batch_geometry_alloc(pts), mixed_geometry(pts),
                      device=cuda)
    tr = stack_traces([build_trace(p, device=cuda) for p in pts])
    tn = stack_tunables(pts, sys_.p.queue_depth, cuda)
    st = sys_.run_chunk_batch(sys_.init_batch(tn), tr, None, 20, tn)
    m, p, t = st.mem, sys_.p, sys_.t
    rs_a, _ = active_geometry(p, tn)
    cb = sys_._bank_ids.expand(B, -1)
    ci = m.rq_row.flatten(1)
    plan = ctl.build_read_patterns(
        p, t, cb, ci, m.rq_age.flatten(1), m.rq_valid.flatten(1),
        sys_._idle_ports(B), m.fresh_loc, m.parity_valid, m.region_slot,
        rs_a)
    assert int(plan.served.sum()) > 0
    torch.cuda.synchronize()
    before = gat_kernel.launches
    with _AtenOps() as seen:
        vals = sys_._read_values(m, plan, cb, ci, rs_a)
    torch.cuda.synchronize()
    assert seen.ops == ["aten.empty.memory_format"]
    assert gat_kernel.launches == before + 1
    assert torch.equal(vals, g_ops.gather_plan_plain(
        m.banks_data, m.parity_data, cb, ci, plan.mode, plan.served,
        m.region_slot, m.fresh_loc, rs_a, p.region_size, t.opt_parity,
        t.opt_sibs))
    done = [(b, b % p.n_regions, b % p.n_slots, p.region_size)
            for b in range(B)]
    before = enc_kernel.launches
    with _AtenOps() as seen:
        out = enc_ops.encode_regions(p, t, m.banks_data, m.parity_data, done)
    torch.cuda.synchronize()
    assert enc_kernel.launches == before + 1
    allowed = {"aten.lift_fresh.default", "aten._to_copy.default",
               "aten.clone.default", "aten.empty.memory_format",
               "aten.empty_strided.default", "aten.copy_.default"}
    assert set(seen.ops) <= allowed and len(seen.ops) <= 4, seen.ops
    assert torch.equal(out, encode_regions_plain(
        m.banks_data, m.parity_data, t.par_members,
        torch.tensor(done, dtype=torch.int32), p.region_size))
