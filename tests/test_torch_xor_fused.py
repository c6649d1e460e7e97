"""The fused entries of the port's simulator kernels (plain PyTorch
versions, the CPU datapath) against the JAX package, bit for bit:
``xor_gather.ops.gather_plan`` (the controller's read plan served
directly; its plain version is ``gather_decode_plain`` of
``plan_columns``) against JAX's ``plan_columns`` plus its reference gather
(and, where a point's region size is traced, JAX's own
``CodedMemorySystem._read_values``), and ``xor_encode.ops.encode_regions``
(dynamic coding's region encodes of several points, written into a copy
of the parity state) against JAX's ``_encode_region_data``. Inputs are
made with numpy from a seed and handed to both; torch runs on one thread.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dynamic as jdyn
from repro.core import system as jsys
from repro.core.codes import get_tables as jget_tables
from repro.kernels.xor_gather import ops as jg_ops
from repro.kernels.xor_gather.ref import gather_decode_ref
from repro_torch.core import controller as tctl
from repro_torch.core.codes import get_tables
from repro_torch.kernels.xor_encode import ops as enc_ops
from repro_torch.kernels.xor_encode.kernel import (encode_parities_cuda,
                                                   encode_regions_cuda)
from repro_torch.kernels.xor_encode.ref import (encode_parities_plain,
                                                encode_regions_plain)
from repro_torch.kernels.xor_gather import ops as g_ops
from repro_torch.kernels.xor_gather.kernel import gather_plan_cuda


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ gather_plan
def plan_inputs(rng, B, scheme="scheme_i", n=24, rows=32, region_size=8,
                n_slots=3, out_of_range=True):
    """B points' plans at one geometry: every mode (-1 .. 7), served at
    random, candidate banks and rows past either end (clamped), fresh_loc
    holders past the last parity, region slots past the last slot; banks
    and parities of random int32 bits."""
    t = get_tables(scheme)
    nd, npar = t.n_data, t.par_members.shape[0]
    n_regions, prows = rows // region_size, n_slots * region_size
    lo, hi = (-2, 2) if out_of_range else (0, 0)
    return t, dict(
        cand_bank=rng.integers(lo, nd + hi, (B, n)),
        cand_row=rng.integers(lo, rows + hi, (B, n)),
        mode=rng.integers(-1, 8, (B, n)),
        served=rng.random((B, n)) < 0.8,
        region_slot=rng.integers(-1, n_slots + (1 if out_of_range else 0),
                                 (B, n_regions)),
        fresh_loc=rng.integers(0, npar + (3 if out_of_range else 1),
                               (B, nd, rows)),
        banks=rng.integers(-2**31, 2**31, (B, nd, rows), dtype=np.int64),
        parities=rng.integers(-2**31, 2**31, (B, npar, prows),
                              dtype=np.int64))


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def port_gather(t, a, region_size, rs_active=None, point=None):
    """``g_ops.gather_plan`` on the CPU: all points, or one as (N,)."""
    sel = (lambda x: x) if point is None else (lambda x: x[point])
    plan = tctl.ReadPlan(served=torch.from_numpy(sel(a["served"])),
                         mode=_i32(sel(a["mode"])), port_busy=None,
                         n_served=None, n_degraded=None)
    return g_ops.gather_plan(
        tctl.jtables(t), plan, _i32(sel(a["cand_bank"])),
        _i32(sel(a["cand_row"])), _i32(sel(a["region_slot"])), region_size,
        _i32(sel(a["fresh_loc"])), rs_active, _i32(sel(a["banks"])),
        _i32(sel(a["parities"])))


def jax_point(scheme, a, b, region_size, rs_a):
    """JAX's served values of point ``b``: ``plan_columns`` + its reference
    gather where the region size is the allocation's, else
    ``CodedMemorySystem._read_values`` (which takes the traced one)."""
    jt = jget_tables(scheme)
    mode, served = jnp.asarray(a["mode"][b], jnp.int32), \
        jnp.asarray(a["served"][b])
    cb = jnp.asarray(a["cand_bank"][b], jnp.int32)
    ci = jnp.asarray(a["cand_row"][b], jnp.int32)
    rslot = jnp.asarray(a["region_slot"][b], jnp.int32)
    fresh = jnp.asarray(a["fresh_loc"][b], jnp.int32)
    banks = jnp.asarray(a["banks"][b].astype(np.int32).view(np.uint32))
    pars = jnp.asarray(a["parities"][b].astype(np.int32).view(np.uint32))
    plan = SimpleNamespace(mode=mode, served=served)
    if rs_a == region_size:
        cols = jg_ops.plan_columns(jt, plan, cb, ci, rslot, region_size,
                                   fresh)
        out = gather_decode_ref(banks[..., None], pars[..., None], *cols)
        return np.asarray(out)[:, 0].view(np.int32)
    fake = SimpleNamespace(
        p=SimpleNamespace(region_size=region_size),
        t=SimpleNamespace(opt_parity=jnp.asarray(jt.opt_parity),
                          opt_sibs=jnp.asarray(jt.opt_sibs)))
    m = SimpleNamespace(region_slot=rslot, banks_data=banks,
                        fresh_loc=fresh, parity_data=pars)
    out = jsys.CodedMemorySystem._read_values(fake, m, plan, cb, ci, rs_a)
    return np.asarray(out).view(np.int32)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("scheme", ["scheme_i", "scheme_iii"])
def test_gather_plan_plain_matches_jax(scheme, B):
    """Every mode, unserved requests and out-of-range ids: each point of
    the batched call equals JAX's plan_columns + reference gather, and the
    batched call equals ``gather_decode`` of ``plan_columns`` (B·N,)."""
    rng = np.random.default_rng(B * 10 + len(scheme))
    t, a = plan_inputs(rng, B, scheme)
    got = port_gather(t, a, 8)
    assert got.shape == (B, 24) and got.dtype == torch.int32
    for b in range(B):
        np.testing.assert_array_equal(got[b].numpy(),
                                      jax_point(scheme, a, b, 8, 8))
    if B == 1:                          # one point's (N,) plan
        assert torch.equal(port_gather(t, a, 8, point=0), got[0])
    plan = tctl.ReadPlan(torch.from_numpy(a["served"]), _i32(a["mode"]),
                         None, None, None)
    cols = g_ops.plan_columns(tctl.jtables(t), plan, _i32(a["cand_bank"]),
                              _i32(a["cand_row"]), _i32(a["region_slot"]),
                              8, _i32(a["fresh_loc"]))
    via_cols = g_ops.gather_decode(_i32(a["banks"])[..., None],
                                   _i32(a["parities"])[..., None], cols)
    assert torch.equal(via_cols.view(B, -1), got)


def test_gather_plan_traced_region_size():
    """Each point's own region size (a (B,) tensor, the allocation's
    stride kept): every point equals JAX's ``_read_values`` at its rs_a.
    A served request has a mode >= 0 here, as in the controller's plans
    (``_read_values`` serves a mode of -1 as a direct read, the columns as
    0)."""
    rng = np.random.default_rng(5)
    t, a = plan_inputs(rng, 4, out_of_range=False)
    a["served"] &= a["mode"] >= 0
    rs = np.array([8, 4, 2, 8])
    a["region_slot"] = rng.integers(-1, 3, (4, 32 // 2))   # rows // min rs
    got = port_gather(t, a, 8, rs_active=torch.from_numpy(rs).int())
    for b in range(4):
        np.testing.assert_array_equal(got[b].numpy(),
                                      jax_point("scheme_i", a, b, 8,
                                                int(rs[b])))


def test_gather_plan_empty_plan():
    rng = np.random.default_rng(0)
    t, a = plan_inputs(rng, 3, n=0)
    calls = g_ops.calls
    got = port_gather(t, a, 8)
    assert got.shape == (3, 0) and g_ops.calls == calls + 1
    cols = jg_ops.plan_columns(
        jget_tables("scheme_i"),
        SimpleNamespace(mode=jnp.zeros(0, jnp.int32),
                        served=jnp.zeros(0, bool)),
        jnp.zeros(0, jnp.int32), jnp.zeros(0, jnp.int32),
        jnp.asarray(a["region_slot"][0], jnp.int32), 8,
        jnp.asarray(a["fresh_loc"][0], jnp.int32))
    assert gather_decode_ref(jnp.zeros((8, 32, 1), jnp.uint32),
                             jnp.zeros((12, 24, 1), jnp.uint32),
                             *cols).shape == (0, 1)


def test_gather_plan_on_a_faulted_run(monkeypatch):
    """The plans of a scheme III batch run with a dead bank (reads degraded
    around it: parity ^ two siblings) and unserved requests: every
    ``gather_plan`` call of the run on the CPU, held point by point
    against JAX's plan_columns + reference gather on its own operands."""
    from repro_torch.sweep import SweepPoint, run_points

    seen = []
    plain = g_ops.gather_plan_plain

    def recorded(*args):
        out = plain(*args)
        seen.append((args, out))
        return out

    monkeypatch.setattr(g_ops, "gather_plan_plain", recorded)
    base = SweepPoint(scheme="scheme_iii", n_data=9, n_banks=9, n_rows=32,
                      n_cores=6, length=10, write_frac=0.2, alpha=1.0,
                      r=0.25, select_period=4)
    res = run_points([base.replace(faults=(("bank", 2, 0),)),
                      base.replace(seed=1)], device="cpu")
    assert res[0].fault_degraded_reads > 0
    jt = jget_tables("scheme_iii", n_data=9)
    two = unserved = 0
    for args, out in seen[::3]:
        (banks, pars, cb, ci, mode, served, rslot, fresh, rs_a, rs,
         opt_parity, _) = args
        assert rs_a == rs
        for b in range(cb.shape[0]):
            cols = jg_ops.plan_columns(
                jt, SimpleNamespace(mode=jnp.asarray(mode[b].numpy()),
                                    served=jnp.asarray(served[b].numpy())),
                jnp.asarray(cb[b].numpy()), jnp.asarray(ci[b].numpy()),
                jnp.asarray(rslot[b].numpy()), rs,
                jnp.asarray(fresh[b].numpy()))
            want = gather_decode_ref(
                jnp.asarray(banks[b].numpy().view(np.uint32))[..., None],
                jnp.asarray(pars[b].numpy().view(np.uint32))[..., None],
                *cols)
            np.testing.assert_array_equal(
                out[b].numpy().view(np.uint32), np.asarray(want)[:, 0])
            opt = np.asarray((cols.mode >= 2) & (cols.mode < 6))
            two += int((opt & (np.asarray(cols.sib1) >= 0)).sum())
            unserved += int((~served[b] & (ci[b] >= 0)).sum())
    assert two > 0 and unserved > 0


# ---------------------------------------------------------- encode_regions
def _jax_region(scheme, banks, pars, region, slot, rs_a, rs):
    """JAX's ``_encode_region_data`` on one point's state."""
    jt = jget_tables(scheme)
    p = SimpleNamespace(region_size=rs, n_parities=jt.par_members.shape[0],
                        n_rows=banks.shape[1])
    t = SimpleNamespace(par_members=jnp.asarray(jt.par_members))
    out = jdyn._encode_region_data(
        p, t, jnp.asarray(banks.astype(np.int32)),
        jnp.asarray(pars.astype(np.int32)), jnp.asarray(region),
        jnp.asarray(slot), jnp.asarray(rs_a))
    return np.asarray(out)


@pytest.mark.parametrize("scheme", ["scheme_i", "scheme_iii"])
def test_encode_regions_plain_matches_jax(scheme):
    """Several completing points of a batch of 6 (a region past the last
    row, a slot past the last one, slot -1, traced region sizes below the
    allocation's): each point equals JAX's region encode, the others are
    untouched, and the input state is left as it was."""
    rng = np.random.default_rng(len(scheme))
    t = get_tables(scheme)
    nd, npar = t.n_data, t.par_members.shape[0]
    B, rows, rs, n_slots = 6, 40, 8, 3
    banks = rng.integers(-2**31, 2**31, (B, nd, rows), dtype=np.int64)
    pars = rng.integers(-2**31, 2**31, (B, npar, n_slots * rs),
                        dtype=np.int64)
    done = [(0, 1, 2, 8), (2, 4, 5, 8), (3, 9, -1, 6), (5, 2, 1, 3)]
    tb, tp = _i32(banks), _i32(pars)
    before = tp.clone()
    p = SimpleNamespace(region_size=rs)
    calls = enc_ops.calls
    got = enc_ops.encode_regions(p, tctl.jtables(t), tb, tp, done)
    assert enc_ops.calls == calls + 1 and torch.equal(tp, before)
    assert torch.equal(got, encode_regions_plain(
        tb, tp, tctl.jtables(t).par_members, _i32(np.array(done)), rs))
    touched = {b for b, *_ in done}
    for b in range(B):
        if b not in touched:
            assert torch.equal(got[b], tp[b])
    for b, region, slot, rs_a in done:
        want = _jax_region(scheme, banks[b], pars[b], region, slot, rs_a, rs)
        np.testing.assert_array_equal(got[b].numpy(), want)
    with pytest.raises(ValueError, match="outside the batch"):
        enc_ops.encode_regions(p, tctl.jtables(t), tb, tp, [(B, 0, 0, 8)])


def test_encode_parities_batched_members_stay_in_their_point():
    """Banks (B, n_data, L, W) with the one-point table: each point XORs
    its own banks, a member past the last bank clamped inside the point."""
    rng = np.random.default_rng(2)
    banks = _i32(rng.integers(-2**31, 2**31, (3, 4, 5, 2), dtype=np.int64))
    members = torch.tensor([[0, 1, -1], [2, 9, -1], [3, 3, 1]])
    got = encode_parities_plain(banks, members)
    assert got.shape == (3, 3, 5, 2)
    for b in range(3):
        assert torch.equal(got[b], encode_parities_plain(banks[b], members))
    assert torch.equal(got[:, 1], banks[:, 2] ^ banks[:, 3])
    assert torch.equal(got[:, 2], banks[:, 1])            # 3 ^ 3 cancels
    assert torch.equal(enc_ops.encode_parities(banks, members), got)


# --------------------------------------------- the wrappers never fall back
def test_fused_cuda_wrappers_reject_cpu_tensors():
    rng = np.random.default_rng(0)
    t, a = plan_inputs(rng, 2)
    jt = tctl.jtables(t)
    with pytest.raises(ValueError, match="not on the CUDA card"):
        gather_plan_cuda(_i32(a["banks"]), _i32(a["parities"]),
                         _i32(a["cand_bank"]), _i32(a["cand_row"]),
                         _i32(a["mode"]), torch.from_numpy(a["served"]),
                         _i32(a["region_slot"]), _i32(a["fresh_loc"]), 8, 8,
                         jt.opt_parity, jt.opt_sibs)
    with pytest.raises(ValueError, match="not on the CUDA card"):
        encode_regions_cuda(_i32(a["banks"]), _i32(a["parities"]),
                            jt.par_members, torch.zeros((1, 4),
                                                        dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="not on the CUDA card"):
        encode_parities_cuda(_i32(a["banks"])[..., None], jt.par_members)
