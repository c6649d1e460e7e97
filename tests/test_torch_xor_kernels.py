"""The port's simulator kernels (plain PyTorch versions, the CPU datapath)
against the JAX package's references, bit for bit: the coded row gather
(``xor_gather``), the parity encoder (``xor_encode``) and the plan →
columns bridge. The JAX side runs its plain ``ref.py`` versions, never the
Pallas interpreter. Inputs are made with numpy from a seed and handed to
both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as jctl
from repro.core.codes import get_tables as jget_tables
from repro.core.state import make_params as jmake_params
from repro.kernels.xor_encode.ref import encode_parities_ref
from repro.kernels.xor_gather import ops as jg_ops
from repro.kernels.xor_gather.ref import gather_decode_ref
from repro_torch.core import controller as tctl
from repro_torch.core.codes import get_tables
from repro_torch.core.state import make_params
from repro_torch.kernels.xor_encode import ops as enc_ops
from repro_torch.kernels.xor_encode.kernel import encode_parities_cuda
from repro_torch.kernels.xor_encode.ref import encode_parities_plain
from repro_torch.kernels.xor_gather import ops as g_ops
from repro_torch.kernels.xor_gather.kernel import gather_decode_cuda
from repro_torch.kernels.xor_gather.ref import gather_decode_plain

_read_jax = jax.jit(jctl.build_read_pattern, static_argnums=0)

# numpy unsigned lane type -> the port's signed lane view
_SIGNED = {np.uint8: np.int8, np.uint16: np.int16, np.uint32: np.int32}


def _t(a: np.ndarray) -> torch.Tensor:
    """The port's tensor of a numpy array (unsigned lanes as signed)."""
    a = np.ascontiguousarray(a)
    if a.dtype.type in _SIGNED:
        a = a.view(_SIGNED[a.dtype.type])
    return torch.from_numpy(a.copy())


def _u(t: torch.Tensor, u) -> np.ndarray:
    return t.numpy().view(u)


def gather_requests(rng, n, n_data, rows, n_par, prows):
    """Columns covering every mode (-1 .. 7), siblings of -1 and indices
    past either end of their arrays."""
    bank = rng.integers(-2, n_data + 2, n).astype(np.int32)
    row = rng.integers(-2, rows + 2, n).astype(np.int32)
    mode = rng.integers(-1, 8, n).astype(np.int32)
    par = rng.integers(-1, n_par + 2, n).astype(np.int32)
    prow = rng.integers(-1, prows + 2, n).astype(np.int32)
    sib0 = rng.integers(-1, n_data + 1, n).astype(np.int32)
    sib1 = rng.integers(-1, n_data + 1, n).astype(np.int32)
    return bank, row, mode, par, prow, sib0, sib1


LANES = {"int8": np.uint8, "int16": np.uint16, "int32": np.uint32,
         "float32": np.uint32}


@pytest.mark.parametrize("w", [1, 3, 256])
@pytest.mark.parametrize("n", [0, 1, 7, 80])
@pytest.mark.parametrize("lanes", sorted(LANES))
def test_gather_decode_plain_matches_jax_ref(lanes, n, w):
    u = LANES[lanes]
    rng = np.random.default_rng(n * 1000 + w)
    n_data, rows, n_par, prows = 8, 12, 5, 6
    banks = rng.integers(0, np.iinfo(u).max, (n_data, rows, w),
                         endpoint=True, dtype=u)
    pars = rng.integers(0, np.iinfo(u).max, (n_par, prows, w),
                        endpoint=True, dtype=u)
    cols = gather_requests(rng, n, n_data, rows, n_par, prows)
    want = np.asarray(gather_decode_ref(jnp.asarray(banks), jnp.asarray(pars),
                                        *map(jnp.asarray, cols)))
    tb, tp = _t(banks), _t(pars)
    if lanes == "float32":                 # float banks go through bit views
        tb, tp = tb.view(torch.float32), tp.view(torch.float32)
    got = gather_decode_plain(tb, tp, *map(_t, cols))
    assert got.shape == (n, w)
    np.testing.assert_array_equal(_u(got, u), want)
    # the public wrapper takes the same CPU datapath and returns the
    # banks' own dtype
    out = g_ops.gather_decode(tb, tp, g_ops.PlanColumns(*map(_t, cols)))
    assert out.dtype == tb.dtype and out.shape == (n, w)
    np.testing.assert_array_equal(_u(out.view(got.dtype), u), want)


def test_gather_decode_degraded_reads_reconstruct_rows():
    """A degraded read through a parity encoded from the banks returns the
    logical row itself (the datapath's reason to exist)."""
    t = get_tables("scheme_i")
    rng = np.random.default_rng(3)
    banks = torch.from_numpy(rng.integers(-2**31, 2**31, (8, 16, 4),
                                          dtype=np.int64).astype(np.int32))
    par = enc_ops.encode_parities(banks, t.par_members)
    b = torch.arange(8).repeat(2)
    k = torch.arange(16) % 3
    j = torch.as_tensor(t.opt_parity)[b, k]
    sibs = torch.as_tensor(t.opt_sibs)[b, k]
    row = torch.arange(16) % 16
    cols = g_ops.PlanColumns(*(c.int() for c in (
        b, row, k + tctl.MODE_OPT0, j, row, sibs[:, 0], sibs[:, 1])))
    out = g_ops.gather_decode(banks, par, cols)
    assert torch.equal(out, banks[b, row])


# ---------------------------------------------------------------- xor_encode
ENC_DTYPES = ["bfloat16", "float32", "uint16", "int32"]


@pytest.mark.parametrize("dtype", ENC_DTYPES)
@pytest.mark.parametrize("rows,width", [(16, 128), (32, 256), (8, 384)])
@pytest.mark.parametrize("scheme", ["scheme_i", "scheme_iii"])
def test_encode_parities_plain_matches_jax_ref(dtype, rows, width, scheme):
    """Mirrors the JAX package's ``test_xor_encode_sweep``: 4 dtypes × 3
    shapes × scheme_i/scheme_iii members."""
    n_data = 9 if scheme == "scheme_iii" else 8
    t = jget_tables(scheme, n_data=n_data)
    u = np.uint16 if dtype in ("bfloat16", "uint16") else np.uint32
    rng = np.random.default_rng(rows * width)
    bits = rng.integers(0, np.iinfo(u).max, (n_data, rows, width),
                        endpoint=True, dtype=u)
    want = np.asarray(encode_parities_ref(jnp.asarray(bits),
                                          jnp.asarray(t.par_members)))
    tb = _t(bits)
    if dtype in ("bfloat16", "float32"):
        tb = tb.view(getattr(torch, dtype))
    got = encode_parities_plain(tb, torch.from_numpy(t.par_members))
    np.testing.assert_array_equal(_u(got, u), want)
    # the public wrapper pads a ragged member list itself
    out = enc_ops.encode_parities(tb, [list(m) for m in t.scheme.members])
    np.testing.assert_array_equal(_u(out, u), want)


def test_encode_parities_pairwise_members():
    """``bench_kernels``' member table: pairs (2g, 2g+1), padded to 3."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, (8, 16, 8), dtype=np.uint32)
    members = [[2 * g, 2 * g + 1] for g in range(4)]
    got = enc_ops.encode_parities(_t(bits), members)
    want = bits[0::2] ^ bits[1::2]
    np.testing.assert_array_equal(_u(got, np.uint32), want)
    table = enc_ops.member_table(members, "cpu")
    assert table.dtype == torch.int32 and table.shape == (4, 3)
    assert (table[:, 2] == -1).all()


# ------------------------------------------------------------- plan columns
def _rand_plan_inputs(rng, scheme, n_rows=16, alpha=0.5, r=0.25, n=24):
    """A random reachable controller state and candidate set (the shape of
    ``tests/test_conformance.py``'s randomized plans)."""
    jt = jget_tables(scheme)
    p = jmake_params(jt, n_rows=n_rows, alpha=alpha, r=r)
    nb = p.n_data
    n_logical = len(jt.scheme.members)
    fresh = np.asarray(rng.integers(0, n_logical + 1, (nb, n_rows))
                       * (rng.random((nb, n_rows)) < 0.25), np.int32)
    pv = rng.random((p.n_parities, p.n_slots * p.region_size)) < 0.7
    rslot = np.full(p.n_regions, -1, np.int32)
    k = rng.integers(0, min(p.n_slots, p.n_regions) + 1)
    rslot[rng.permutation(p.n_regions)[:k]] = rng.permutation(p.n_slots)[:k]
    cb = rng.integers(0, nb, n).astype(np.int32)
    ci = rng.integers(0, n_rows, n).astype(np.int32)
    ca = rng.integers(0, 50, n).astype(np.int32)
    cv = rng.random(n) < 0.8
    pb = np.append(rng.random(p.n_ports) < 0.3, False)
    return jt, p, (cb, ci, ca, cv, pb, fresh, pv, rslot)


@pytest.mark.parametrize("scheme", ["scheme_i", "scheme_ii", "scheme_iii",
                                    "replication_2"])
def test_plan_columns_match_jax(scheme):
    for seed in range(4):
        rng = np.random.default_rng(seed)
        jt, jp, arrs = _rand_plan_inputs(rng, scheme)
        jplan = _read_jax(jp, jctl.jtables(jt), *map(jnp.asarray, arrs))
        jcols = jg_ops.plan_columns(jt, jplan, jnp.asarray(arrs[0]),
                                    jnp.asarray(arrs[1]),
                                    jnp.asarray(arrs[7]), jp.region_size,
                                    jnp.asarray(arrs[5]))
        tt = get_tables(scheme)
        tp = make_params(tt, n_rows=16, alpha=0.5, r=0.25)
        ttab = tctl.jtables(tt)
        tplan = tctl.build_read_pattern(tp, ttab, *map(_t, arrs))
        tcols = g_ops.plan_columns(ttab, tplan, _t(arrs[0]), _t(arrs[1]),
                                   _t(arrs[7]), tp.region_size, _t(arrs[5]))
        for name in jg_ops.PlanColumns._fields:
            got = getattr(tcols, name)
            assert got.dtype == torch.int32, name
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(jcols, name)),
                err_msg=f"{scheme} seed {seed}: column {name}")
        # and the served values through both datapaths
        rng2 = np.random.default_rng(100 + seed)
        banks = rng2.integers(0, 2**32, (tp.n_data, 16, 1), dtype=np.uint32)
        pars = rng2.integers(0, 2**32, (tp.n_parities,
                                        tp.n_slots * tp.region_size, 1),
                             dtype=np.uint32)
        want = gather_decode_ref(jnp.asarray(banks), jnp.asarray(pars),
                                 *jcols)
        got = g_ops.gather_decode(_t(banks), _t(pars), tcols)
        np.testing.assert_array_equal(_u(got, np.uint32), np.asarray(want))


# --------------------------------------------- the wrappers never fall back
def test_gather_decode_cuda_rejects_cpu_tensors():
    cols = [torch.zeros(3, dtype=torch.int32)] * 7
    with pytest.raises(ValueError, match="not on the CUDA card"):
        gather_decode_cuda(torch.zeros((8, 4, 2), dtype=torch.int32),
                           torch.zeros((4, 4, 2), dtype=torch.int32), *cols)


def test_encode_parities_cuda_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="not on the CUDA card"):
        encode_parities_cuda(torch.zeros((8, 4, 2), dtype=torch.int32),
                             torch.full((4, 3), -1, dtype=torch.int32))


def test_jax_is_on_cpu():
    assert jax.default_backend() == "cpu"
