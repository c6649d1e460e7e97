"""The port's pool gather (plain PyTorch version, the CPU datapath) against
the JAX package's reference gather, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.coded_kv_decode import ops as jops
from repro.kernels.common import bxor as jbxor
from repro_torch.kernels.coded_kv_decode import ops as tops
from repro_torch.kernels.coded_kv_decode.kernel import gather_pool_cuda
from repro_torch.kernels.common import bxor

# value dtype -> (JAX lane dtype, the port's lane dtype)
_LANES = {"bfloat16": (np.uint16, torch.int16),
          "float32": (np.uint32, torch.int32)}


def _inputs(seed, dtype, coded, mix, *, nb=8, slots=6, page=4, hkv=2, d=8,
            b=3, mp=5):
    rng = np.random.default_rng(seed)
    u = _LANES[dtype][0]
    shape = (nb, slots, page, hkv, d)
    ng = nb // 2 if coded else 0
    hi = np.iinfo(u).max

    def bits(s):
        return rng.integers(0, hi, size=s, endpoint=True, dtype=u)

    pt = rng.integers(0, nb * slots, size=(b, mp)).astype(np.int32)
    pt[rng.random((b, mp)) < 0.25] = -1
    up = {"all": np.ones((b, mp), bool), "none": np.zeros((b, mp), bool),
          "random": rng.random((b, mp)) < 0.4}[mix]
    return (bits(shape), bits(shape), bits((ng,) + shape[1:]),
            bits((ng,) + shape[1:]), pt, up)


def _signed(a):
    """The port's signed-lane view of JAX's unsigned lane bits."""
    return torch.from_numpy(a.view(f"i{a.dtype.itemsize}"))


CASES = [(dtype, coded, mix, seed)
         for dtype in ("bfloat16", "float32")
         for coded, mix in ((True, "random"), (True, "all"), (True, "none"),
                            (False, "random"))
         for seed in (0, 1)]


@pytest.mark.parametrize("dtype,coded,mix,seed", CASES)
def test_gather_pool_plain_matches_jax_reference(dtype, coded, mix, seed):
    kb, vb, kp, vp, pt, up = _inputs(seed, dtype, coded, mix)
    jk, jv = jops.gather_pool_layer(
        jnp.asarray(kb), jnp.asarray(vb), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pt), jnp.asarray(up), jnp.dtype(dtype),
        kernel="reference")
    tk, tv = tops.gather_pool_layer(
        _signed(kb), _signed(vb), _signed(kp), _signed(vp),
        torch.from_numpy(pt), torch.from_numpy(up), getattr(torch, dtype))
    u, lanes = _LANES[dtype]
    assert tk.dtype == getattr(torch, dtype) and tk.shape == jk.shape
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(t.view(lanes).numpy().view(u),
                                      np.asarray(j).view(u))


def test_gather_pool_holes_read_zero():
    kb, vb, kp, vp, pt, up = _inputs(3, "bfloat16", True, "all")
    pt[:] = -1
    tk, tv = tops.gather_pool_layer(
        _signed(kb), _signed(vb), _signed(kp), _signed(vp),
        torch.from_numpy(pt), torch.from_numpy(up), torch.bfloat16)
    assert not tk.view(torch.int16).any() and not tv.view(torch.int16).any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bxor_matches_jax(dtype):
    rng = np.random.default_rng(9)
    a, b = (rng.standard_normal((3, 5)).astype(np.float32) for _ in "ab")
    ja, jb = (jnp.asarray(x).astype(dtype) for x in (a, b))
    ta, tb = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, b))
    u, lanes = _LANES[dtype]
    out = bxor(ta, tb)
    assert out.dtype == ta.dtype
    np.testing.assert_array_equal(out.view(lanes).numpy().view(u),
                                  np.asarray(jbxor(ja, jb)).view(u))
    assert torch.equal(bxor(out, tb).view(lanes), ta.view(lanes))


def test_gather_pool_cuda_rejects_cpu_tensors():
    """The kernel wrapper never falls back: CPU tensors raise."""
    kb, vb, kp, vp, pt, up = _inputs(0, "bfloat16", True, "random")
    with pytest.raises(ValueError, match="not on the CUDA card"):
        gather_pool_cuda(_signed(kb), _signed(vb), _signed(kp), _signed(vp),
                         torch.from_numpy(pt), torch.from_numpy(up))
