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
