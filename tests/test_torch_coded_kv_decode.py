"""Decode attention over per-sequence coded KV banks: the port's
``pack_kv_banks``, ``coded_kv_decode`` (on the CPU: its plain version) and
``coded_kv_decode_pool`` against the JAX package.

The JAX Pallas kernel cannot trace in this container (no ``pl.load``), so
the JAX anchor is ``ref.decode_attention_ref`` over the logical cache plus
``ops.pack_kv_banks``, never interpret mode. Inputs are made with numpy
from seeds. Tolerances: f32 rtol = atol = 1e-5 (the two frameworks sum in
different orders); bf16 and f16 at most 1 ulp of the output type (the f32
results differ in the last bits, which can move one rounding step)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.coded_kv_decode import ops as jops
from repro.kernels.coded_kv_decode.ref import decode_attention_ref
from repro_torch.kernels.coded_kv_decode import ops as tops
from repro_torch.kernels.coded_kv_decode.ref import (coded_kv_decode_plain,
                                                     decode_attention_plain)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"float32": (jnp.float32, torch.float32, np.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, None),
          "float16": (jnp.float16, torch.float16, np.float16)}


def _jax(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(DTYPES[dtype][0])


def _torch(x):
    """A JAX array as a torch tensor of the same bits."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype.kind == "u":
        return torch.from_numpy(a.view(f"i{a.dtype.itemsize}").copy())
    return torch.from_numpy(a.copy())


def _bits(t):
    """A tensor's bits as unsigned numpy lanes (the JAX package's view)."""
    if t.dtype.is_floating_point:
        t = t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    a = t.numpy()
    return a.view(f"u{a.dtype.itemsize}")


def _ulps(a, b):
    """Distance in units in the last place between two 16-bit float
    tensors of the same type."""
    def key(t):
        u = t.view(torch.int16).numpy().astype(np.int32) & 0xFFFF
        return np.where(u & 0x8000, -(u & 0x7FFF), u & 0x7FFF)
    return np.abs(key(a) - key(b))


def assert_close(got, want_jax, dtype):
    want = _torch(want_jax)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    else:
        assert _ulps(got, want).max() <= 1


def _case(seed, b, t, h, hkv, d, dtype):
    rng = np.random.default_rng(seed)
    k = _jax(rng.normal(size=(b, t, hkv, d)), dtype)
    v = _jax(rng.normal(size=(b, t, hkv, d)), dtype)
    q = _jax(rng.normal(size=(b, h, d)), dtype)
    return rng, q, k, v


# ------------------------------------------------------------ pack_kv_banks
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nb,page,t", [(4, 8, 64), (8, 4, 96), (2, 16, 32)])
def test_pack_kv_banks_bit_exact(dtype, nb, page, t):
    _, _, k, v = _case(1, 2, t, 4, 2, 16, dtype)
    want = jops.pack_kv_banks(k, v, nb, page)
    got = tops.pack_kv_banks(_torch(k), _torch(v), nb, page)
    assert got[4] == want[4] == t // page
    for g, w in zip(got[:4], want[:4]):
        assert g.is_contiguous() and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_bits(g), np.asarray(w))


def test_pack_kv_banks_refuses_bad_geometry():
    k = torch.zeros(1, 24, 1, 8)
    with pytest.raises(ValueError, match="even"):
        tops.pack_kv_banks(k, k, 3, 8)
    with pytest.raises(ValueError, match="multiple"):
        tops.pack_kv_banks(k, k, 4, 8)


# ------------------------------------------------------- coded_kv_decode
# name: (dtype, value_dtype given, b, t, h, hkv, d, nb, page, n_pages cut)
CASES = {
    "f32_g1": ("float32", False, 3, 64, 2, 2, 16, 4, 8, 0),
    "f32_g2": ("float32", False, 3, 128, 4, 2, 32, 4, 8, 0),
    "f32_g8": ("float32", False, 3, 64, 16, 2, 16, 4, 4, 0),
    "bf16_g1": ("bfloat16", False, 3, 64, 4, 4, 32, 4, 8, 0),
    "bf16_g2": ("bfloat16", False, 3, 128, 8, 4, 64, 4, 16, 0),
    "bf16_g8": ("bfloat16", False, 3, 128, 16, 2, 32, 8, 8, 0),
    "f16_value_dtype_g2": ("float16", True, 3, 64, 4, 2, 32, 4, 8, 0),
    "f32_fewer_pages_than_slots": ("float32", False, 3, 128, 4, 2, 16, 4,
                                   8, 5),
    "bf16_fewer_pages_than_slots": ("bfloat16", False, 3, 128, 8, 2, 32, 8,
                                    4, 11),
    # a 40-lane head (stablelm-12b reduced with head_dim 40: an 80-byte
    # bf16 row) and 24 query heads on one kv head (granite's MQA kind)
    "f32_d40": ("float32", False, 3, 64, 4, 2, 40, 4, 8, 0),
    "bf16_d40": ("bfloat16", False, 3, 64, 8, 2, 40, 4, 8, 0),
    "f32_g24": ("float32", False, 3, 64, 24, 1, 16, 4, 8, 0),
    "bf16_g24": ("bfloat16", False, 3, 64, 48, 2, 32, 4, 8, 0),
    # phi-3-vision-4.2b's kind (MHA, D = 96: a 192-byte row, 12 chunks of
    # 16 bytes on the card's tensor cores), recurrentgemma-9b's MQA head in
    # f32 lanes (D = 256, G = 16: a 1,024-byte row), and widths only the
    # card's general kernel takes: a 400-byte f16 row, a 26-byte bf16 one
    "bf16_d96_mha": ("bfloat16", False, 3, 64, 4, 4, 96, 4, 8, 0),
    "f32_d256_g16": ("float32", False, 3, 64, 16, 1, 256, 4, 8, 0),
    "f16_d200": ("float16", False, 3, 128, 8, 2, 200, 4, 8, 0),
    "bf16_d13": ("bfloat16", False, 3, 64, 4, 2, 13, 4, 8, 0),
    # reduced forms of the shapes the card's kernels were redesigned for:
    # recurrentgemma-9b's D = 256 at G = 16 (two head groups of 8), MHA at
    # phi-3-vision's D = 96, granite-20b's G = 48 at D = 128, and D = 100
    # (the general kernel's small register tiling)
    "bf16_d256_g16": ("bfloat16", False, 3, 64, 16, 1, 256, 4, 8, 0),
    "bf16_d96_g1": ("bfloat16", False, 3, 128, 2, 2, 96, 4, 8, 0),
    "bf16_d128_g48": ("bfloat16", False, 3, 64, 48, 1, 128, 4, 8, 0),
    "bf16_d100": ("bfloat16", False, 3, 128, 8, 2, 100, 8, 8, 0),
}


def _seq_lens(t, page):
    # an empty sequence, a partial page, the full cache
    return np.asarray([0, page + 3, t], np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_coded_kv_decode_matches_jax_ref(case):
    dtype, give_vd, b, t, h, hkv, d, nb, page, cut = CASES[case]
    rng, q, k, v = _case(2, b, t, h, hkv, d, dtype)
    kb, vb, kp, vp, n_pages = jops.pack_kv_banks(k, v, nb, page)
    n_plan = n_pages - cut                 # plan fewer pages than NB*S
    use_par = rng.random((b, n_plan)) < 0.5
    use_par[1] = True                      # one sequence all degraded
    seq = _seq_lens(n_plan * page, page)
    want = decode_attention_ref(q, k[:, :n_plan * page], v[:, :n_plan * page],
                                jnp.asarray(seq))
    kw = {"value_dtype": DTYPES[dtype][1]} if give_vd else {}
    got = tops.coded_kv_decode(
        _torch(q), _torch(kb), _torch(vb), _torch(kp), _torch(vp),
        torch.from_numpy(use_par), torch.from_numpy(seq), **kw)
    assert_close(got, want, dtype)
    assert not got[0].any(), "seq_len 0 must read exact zeros"


def test_coded_kv_decode_f16_d200_within_one_ulp_of_f64():
    """f16 at D = 200, B = 3, T = 64, H = 4 on 2 kv heads: every output
    within one ulp of the f64 value rounded. Held against f64, not JAX's
    reference: one output here is -1.62e-4, where JAX's f32 result lies
    2.1e-7 (two f16 ulps) from the f64 value and the port's rounds to it."""
    rng, q, k, v = _case(2, 3, 64, 4, 2, 200, "float16")
    kb, vb, kp, vp, n_pages = jops.pack_kv_banks(k, v, 4, 8)
    use_par = rng.random((3, n_pages)) < 0.5
    use_par[1] = True
    seq = _seq_lens(n_pages * 8, 8)
    got = tops.coded_kv_decode(
        _torch(q), _torch(kb), _torch(vb), _torch(kp), _torch(vp),
        torch.from_numpy(use_par), torch.from_numpy(seq))
    qf = np.asarray(q, np.float64).reshape(3, 2, 2, 200)
    kf, vf = np.asarray(k, np.float64), np.asarray(v, np.float64)
    s = np.einsum("bgkd,btkd->bgkt", qf, kf) * 200 ** -0.5
    live = np.arange(64)[None, None, None] < seq[:, None, None, None]
    s = np.where(live, s, -np.inf)
    with np.errstate(invalid="ignore"):        # seq_len 0: -inf - -inf
        p = np.where(live, np.exp(s - s.max(-1, keepdims=True)), 0.0)
    p /= np.maximum(p.sum(-1, keepdims=True), 1e-30)
    want = np.nan_to_num(np.einsum("bgkt,btkd->bgkd", p, vf)).reshape(
        3, 4, 200)
    assert _ulps(got, torch.from_numpy(want).half()).max() <= 1
    assert not got[0].any(), "seq_len 0 must read exact zeros"


def test_coded_kv_decode_follows_the_plan_over_stale_parity():
    """Parity built as ``sibling ^ other`` is not the XOR of its pair: a
    degraded read of an even bank's page must return ``other``'s page, so
    the result is attention over the mixed logical cache. A datapath that
    ignored the plan (or the parity) would read the page's own bits."""
    b, t, h, hkv, d, nb, page = 2, 64, 4, 2, 16, 4, 4
    rng, q, k, v = _case(3, b, t, h, hkv, d, "float32")
    _, _, k2, v2 = _case(4, b, t, h, hkv, d, "float32")
    kb, vb, _, _, n_pages = tops.pack_kv_banks(_torch(k), _torch(v), nb, page)
    kb2, vb2, _, _, _ = tops.pack_kv_banks(_torch(k2), _torch(v2), nb, page)
    # parity group g: sibling (odd bank 2g+1, own) ^ other (even bank 2g)
    kp = kb[:, 1::2] ^ kb2[:, 0::2]
    vp = vb[:, 1::2] ^ vb2[:, 0::2]
    pages = np.arange(n_pages)
    even = (pages % nb) % 2 == 0
    use_par = np.broadcast_to(even, (b, n_pages)).copy()
    tok_even = np.repeat(even, page)[None, :, None, None]
    k_mix = np.where(tok_even, np.asarray(k2), np.asarray(k))
    v_mix = np.where(tok_even, np.asarray(v2), np.asarray(v))
    seq = np.asarray([t, t - page // 2], np.int32)
    want = decode_attention_ref(q, jnp.asarray(k_mix), jnp.asarray(v_mix),
                                jnp.asarray(seq))
    got = tops.coded_kv_decode(_torch(q), kb, vb, kp, vp,
                               torch.from_numpy(use_par),
                               torch.from_numpy(seq))
    assert_close(got, want, "float32")
    own = decode_attention_ref(q, k, v, jnp.asarray(seq))
    assert not np.allclose(got.numpy(), np.asarray(own), **F32_TOL)


def test_coded_kv_decode_plain_equals_logical_attention():
    """The banked plain version over fresh parity equals the logical
    plain version bit for bit, whatever the plan."""
    rng, q, k, v = _case(5, 2, 64, 8, 2, 16, "bfloat16")
    tq, tk, tv = _torch(q), _torch(k), _torch(v)
    kb, vb, kp, vp, n_pages = tops.pack_kv_banks(tk, tv, 4, 8)
    seq = torch.tensor([64, 29], dtype=torch.int32)
    want = decode_attention_plain(tq, tk, tv, seq)
    for up in (np.zeros((2, n_pages), bool), np.ones((2, n_pages), bool),
               rng.random((2, n_pages)) < 0.5):
        got = coded_kv_decode_plain(tq, kb, vb, kp, vp,
                                    torch.from_numpy(up), seq, torch.bfloat16)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# ------------------------------------------------- coded_kv_decode_pool
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("coded", [True, False])
def test_coded_kv_decode_pool_matches_jax(dtype, coded):
    nb, slots, page, hkv, d, b, mp, h = 8, 4, 4, 2, 16, 3, 6, 8
    rng = np.random.default_rng(6 + coded)
    shape = (nb, slots, page, hkv, d)
    kvals = _jax(rng.normal(size=shape), dtype)
    vvals = _jax(rng.normal(size=shape), dtype)
    k_banks = jnp.asarray(np.asarray(kvals).view(
        f"u{np.asarray(kvals).dtype.itemsize}"))
    v_banks = jnp.asarray(np.asarray(vvals).view(
        f"u{np.asarray(vvals).dtype.itemsize}"))
    ng = nb // 2 if coded else 0
    k_par = (k_banks[0::2] ^ k_banks[1::2])[:ng]
    v_par = (v_banks[0::2] ^ v_banks[1::2])[:ng]
    pt = rng.permutation(nb * slots)[: b * mp].reshape(b, mp).astype(np.int32)
    pt[rng.random((b, mp)) < 0.2] = -1
    up = (rng.random((b, mp)) < 0.5) & coded
    seq = np.asarray([0, 7, mp * page], np.int32)
    q = _jax(rng.normal(size=(b, h, d)), dtype)
    want = jops.coded_kv_decode_pool(
        q, k_banks, v_banks, k_par, v_par, jnp.asarray(pt), jnp.asarray(up),
        jnp.asarray(seq))
    got = tops.coded_kv_decode_pool(
        _torch(q), _torch(k_banks), _torch(v_banks), _torch(k_par),
        _torch(v_par), torch.from_numpy(pt), torch.from_numpy(up),
        torch.from_numpy(seq))
    assert_close(got, want, dtype)


# ------------------------------------- the tensor-core kernel's arithmetic
from test_torch_gpu_kernels import DECODE_CASES, _decode_inputs  # noqa: E402

from repro_torch.kernels.coded_kv_decode.kernel import (  # noqa: E402
    decode_splits)

LOG2E = 1.4426950408889634
TILE = 8                 # tokens a warp takes at a time


def _parts(x, lane, n):
    """x as n parts of the lane type (each part the rounded remainder),
    returned as f32 tensors of exact lane values."""
    out = []
    for _ in range(n):
        hi = x.to(lane).float()
        out.append(hi)
        x = x - hi
    return out


def _emulate_tc_decode(q, kb, vb, kp, vp, up, seq, vd):
    """``csrc/coded_kv_decode.cu``'s tensor-core arithmetic in plain
    PyTorch: q split into hi + lo of the lane type; the score the sum of
    the hi and lo rows' products (exact lane values, summed in f32), times
    D^-0.5 log2(e); an online softmax over 8-token tiles with exp2; p split
    into hi, lo, lo2; O kept as its two row halves (hi and lo2 products,
    lo products), rescaled together and added at the end."""
    b, nb, _, page, hkv, d = kb.shape
    n_pages = up.shape[1]
    t = torch.arange(n_pages)
    bank, slot = t % nb, t // nb
    deg = up.bool()[..., None, None, None]

    def logical(banks, par):
        pages = torch.where(deg, banks[:, bank ^ 1, slot]
                            ^ par[:, bank // 2, slot], banks[:, bank, slot])
        return pages.reshape(b, n_pages * page, hkv, d).view(vd).float()

    k, v = logical(kb, kp), logical(vb, vp)
    n_tok = k.shape[1]
    g = q.shape[1] // hkv
    q_hi, q_lo = _parts(q.float().reshape(b, g, hkv, d), vd, 2)
    scale2 = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    s = (torch.einsum("bgkd,btkd->bgkt", q_hi, k)
         + torch.einsum("bgkd,btkd->bgkt", q_lo, k)) * scale2
    live = torch.arange(n_tok)[None, None, None] < seq[:, None, None, None]
    s = torch.where(live, s, float("-inf"))
    m = torch.full((b, g, hkv), float("-inf"))
    l = torch.zeros(b, g, hkv)
    o_a = torch.zeros(b, g, hkv, d)
    o_b = torch.zeros(b, g, hkv, d)
    for t0 in range(0, n_tok, TILE):
        st = s[..., t0:t0 + TILE]
        mn = torch.maximum(m, st.amax(-1))
        alpha = torch.where(m == float("-inf"), 0.0, torch.exp2(m - mn))
        p = torch.where(st == float("-inf"), 0.0,
                        torch.exp2(st - mn[..., None]))
        l = l * alpha + p.sum(-1)
        p_hi, p_lo, p_lo2 = _parts(p, vd, 3)
        vt = v[:, t0:t0 + TILE]
        o_a = o_a * alpha[..., None] + (
            torch.einsum("bgkt,btkd->bgkd", p_hi, vt)
            + torch.einsum("bgkt,btkd->bgkd", p_lo2, vt))
        o_b = o_b * alpha[..., None] + torch.einsum("bgkt,btkd->bgkd", p_lo,
                                                    vt)
        m = mn
    out = (o_a + o_b) / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, g * hkv, d).to(q.dtype)


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_tensor_core_precision_plan_meets_the_tolerances(case):
    """The split parts (two of q, three of p) keep the tensor-core kernel's
    arithmetic within the tolerances of the scalar kernel, on the inputs
    of the card's ``DECODE_CASES`` (made on the CPU from the same seed):
    with q in f32 within rtol = atol = 1e-5 of the plain version, with a
    16-bit q within one ulp, a 16-bit q's result the f32 one rounded, and
    seq_len 0 exact zeros. An f32-lane case is taken at its shape with
    bf16 lanes and an f32 q (f32 lanes keep the scalar kernel)."""
    value, qd, b, t, h, hkv, d, nb, page, cut, p_deg, stale = \
        DECODE_CASES[case]
    if value == "f32":
        value, qd = "bf16", "f32"
    q, kb, vb, kp, vp, up, seq, vd = _decode_inputs(
        torch.device("cpu"), 11, value=value, q_dtype=qd, b=b, t=t, h=h,
        hkv=hkv, d=d, nb=nb, page=page, cut=cut, p_deg=p_deg, stale=stale)
    q32 = q.float()
    got32 = _emulate_tc_decode(q32, kb, vb, kp, vp, up, seq, vd)
    want32 = coded_kv_decode_plain(q32, kb, vb, kp, vp, up, seq, vd)
    np.testing.assert_allclose(got32.numpy(), want32.numpy(), **F32_TOL)
    assert not got32[seq == 0].any(), "seq_len 0 must read exact zeros"
    if q.dtype != torch.float32:
        got = _emulate_tc_decode(q, kb, vb, kp, vp, up, seq, vd)
        want = coded_kv_decode_plain(q, kb, vb, kp, vp, up, seq, vd)
        assert _ulps(got, want).max() <= 1
        assert torch.equal(got.view(torch.int16),
                           got32.to(q.dtype).view(torch.int16))


# b, rows (Hkv x head groups), n_pages, SMs, blocks per SM -> splits
SPLITS = {
    "serving_width": ((8, 2, 32, 132, 2), 16),
    "large": ((16, 2, 256, 132, 2), 8),
    "bench_f32": ((2, 2, 16, 132, 7), 16),
    "no_page": ((4, 2, 0, 132, 2), 1),
    "more_pairs_than_the_wave": ((64, 8, 100, 132, 1), 1),
    "no_empty_range": ((1, 1, 10, 132, 2), 10),
    "no_range_left_empty": ((1, 1, 9, 4, 1), 3),  # 3 pages a range
    "unknown_occupancy_counts_as_one": ((1, 1, 500, 132, 0), 125),
    # granite-20b's serving width: Hkv 1 x 3 head groups of 16 heads
    "head_groups": ((8, 3, 32, 132, 2), 11),
    # phi-3-vision-4.2b (MHA, 32 kv heads, 3 blocks an SM): 256 rows on
    # 396 slots take 3 ranges in 2 waves (cost 24), not 1 range in one
    # wave with 35% of the slots empty (33) nor 32 one-page ranges (42)
    "phi_mha": ((8, 32, 32, 132, 3), 3),
    # recurrentgemma-9b: one kv head in two head groups of 8 at D = 256,
    # two blocks an SM; its f32 lanes on the general kernel likewise
    "recurrentgemma_two_groups": ((8, 2, 32, 132, 2), 16),
    "recurrentgemma_one_row": ((8, 1, 32, 132, 2), 32),
    # olmoe-1b-7b (MHA, 16 kv heads)
    "olmoe_mha": ((8, 16, 32, 132, 2), 2),
}


def _cost(b, rows, n_pages, sms, per_sm, ns):
    """waves x (pages a range + 1) of ``ns`` ranges, None where one would
    be empty."""
    per = -(-n_pages // ns)
    if -(-n_pages // per) != ns:
        return None
    return -(-(b * rows * ns) // (sms * max(per_sm, 1))) * (per + 1)


def _check_splits(b, rows, n_pages, sms, per_sm, ns):
    if n_pages == 0:
        assert ns == 1
        return
    per = -(-n_pages // ns)
    assert 1 <= ns <= n_pages
    assert (ns - 1) * per < n_pages <= ns * per         # no empty range
    costs = {k: _cost(b, rows, n_pages, sms, per_sm, k)
             for k in range(1, n_pages + 1)}
    best = min(c for c in costs.values() if c is not None)
    assert costs[ns] == best                            # the least makespan
    assert all(costs[k] is None or costs[k] > best for k in range(1, ns))


@pytest.mark.parametrize("case", sorted(SPLITS))
def test_decode_splits_fill_one_wave(case):
    """Page ranges per (sequence, grid row), by the makespan: the least
    waves x (pages a range + 1) over 1..n_pages, a wave being SMs x blocks
    per SM, the fewest ranges on a tie, at least one page each, none
    empty."""
    (b, rows, n_pages, sms, per_sm), want = SPLITS[case]
    ns = decode_splits(b, rows, n_pages, sms, per_sm)
    assert ns == want
    _check_splits(b, rows, n_pages, sms, per_sm, ns)


from hypothesis import given, settings, strategies as st  # noqa: E402


@settings(max_examples=300, deadline=None)
@given(b=st.integers(1, 64), rows=st.integers(1, 64),
       n_pages=st.integers(0, 300), sms=st.integers(1, 132),
       per_sm=st.integers(0, 8))
def test_decode_splits_least_makespan_property(b, rows, n_pages, sms,
                                               per_sm):
    """For any grid and card: the chosen count has the least waves x
    (pages a range + 1) of every count in 1..n_pages that leaves no range
    empty, no fewer ranges reach it, and no range is empty."""
    ns = decode_splits(b, rows, n_pages, sms, per_sm)
    _check_splits(b, rows, n_pages, sms, per_sm, ns)
