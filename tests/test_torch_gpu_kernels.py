"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card with ``nvcc``; without one it skips
(decided inside the ``cuda`` fixture, never at import). Run on the card:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu_kernels.py

(``--noconftest``: the repo's conftest imports JAX, which the card's
machine does not have; nothing here needs it.)
"""
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
    encode_parities_plain)
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
