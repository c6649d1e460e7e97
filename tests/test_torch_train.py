"""The training slice of the port on the CPU against the JAX package: the
coded embedding's backward, ``loss_fn`` and its gradients (remat off,
"full", "dots" and query chunks), AdamW, ``make_train_step`` (microbatches
included), the data pipeline, gradient compression, the checkpoint, the
``Trainer`` (fault recovery, stragglers) and the launcher, each for the
reduced dense configs, from the same seeded inputs and the same params
(``convert``).

Tolerances (f32 compute unless named; the frameworks sum in different
orders, so floats agree to rounding, integers and bits exactly):
- the coded lookup's forward: bit for bit; its backward: bit for bit in
  f32 and bf16 (duplicate tokens accumulate in order in both);
- the loss: ``LOSS_TOL``; every gradient leaf: ``GRAD_TOL`` of the leaf's
  largest magnitude (measured: <= 2e-6);
- at bf16 compute: the loss within ``BF16_LOSS_TOL``, every gradient leaf
  within ``BF16_GRAD_TOL`` of its largest magnitude (bf16 keeps 8 bits;
  XLA computes fused bf16 chains in f32);
- AdamW on the same gradients: ``OPT_TOL`` (rtol and atol) on params and
  moments, the norm to ``LOSS_TOL``; the schedule to 1e-6 relative;
- ``make_train_step`` and the ``Trainer`` over 3 and 6 steps: loss and
  grad norm to ``LOSS_TOL``, the moments (linear in the gradients) to
  ``GRAD_TOL`` of their largest magnitude, params to ``PARAM_TOL`` x the
  learning rates of the steps run, summed: Adam divides each moment by
  its own root mean square, so a component whose gradients are near zero
  (the k bias, whose gradient softmax cancels but for RoPE: 1e-9 against
  a leaf's 1e-3) turns rounding into a step of up to lr (measured: 2.5%
  of the sum, 6.2e-5 over 3 steps and 1.0e-4 over 6 at lr 1e-3);
- ``n_micro=2`` against ``n_micro=1`` within the port: ``LOSS_TOL``;
- ``make_batch``, the ``Prefetcher``, ``compress_int8``, the checkpoint
  and ``convert``: bit for bit; fault recovery in the port: bit for bit.
"""
import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import get_config as jget_config
from repro.data import pipeline as jdata
from repro.models import embedding as jemb
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.runtime import steps as jsteps
from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch.configs.base import get_config as tget_config
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as tlaunch
from repro_torch.models import embedding as temb
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.optim.adamw import tree_leaves, tree_leaves_with_path
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime import trainer as ttrainer

ARCHS = ("qwen2.5-3b", "yi-6b", "stablelm-12b", "granite-20b")
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 2e-5
BF16_LOSS_TOL = 5e-3
BF16_GRAD_TOL = 5e-2
OPT_TOL = dict(rtol=1e-5, atol=1e-8)
PARAM_TOL = 0.05                   # x the summed learning rates
B, S = 4, 16                       # batch and sequence of every step here
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _param_tol(n_steps):
    cfg = tadamw.OptConfig(**OPT)
    return PARAM_TOL * sum(float(tadamw.cosine_schedule(cfg, s))
                           for s in range(1, n_steps + 1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread each keeps six test
    workers from oversubscribing the cores (torch starts one a core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return tuple(dataclasses.replace(g(arch).reduced(), **kw)
                 for g in (jget_config, tget_config))


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    jc, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, jlm.init_params(jc, jax.random.key(0),
                                                    max_seq=S))


def _tokens(vocab, seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _named(jtree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(jtree)}


def _assert_tree_close(jtree, ttree, rel=None, atol=None, what=""):
    """Every leaf of the port's tree against JAX's, by name: within
    ``rel`` of the leaf's largest magnitude, or ``atol``."""
    jn = _named(jtree)
    tn = {"/".join(p): t for p, t in tree_leaves_with_path(ttree)}
    assert sorted(jn) == sorted(tn), (sorted(jn), sorted(tn))
    for name, a in jn.items():
        a = a.astype(np.float32)
        b = tn[name].detach().float().numpy()
        tol = atol if atol is not None else rel * max(np.abs(a).max(), 1e-30)
        err = np.abs(a - b).max()
        assert err <= tol, f"{what} {name}: max |diff| {err} > {tol}"


# ------------------------------------------------------ the coded lookup
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coded_lookup_forward_and_backward_match_jax(dtype):
    """The coded gather bit for bit (degraded reads included) and its
    backward against ``jax.vjp``, with many duplicate tokens: bit for bit
    in the banks' dtype."""
    rng = np.random.default_rng(3)
    nb, vb, d = 8, 16, 12
    banks32 = rng.normal(size=(nb, vb, d)).astype(np.float32)
    toks = rng.integers(0, 40, (3, 50)).astype(np.int32)   # duplicates
    g32 = rng.normal(size=(3, 50, d)).astype(np.float32)
    jb = jnp.asarray(banks32).astype(dtype)

    @jax.jit
    def fwd_bwd(b, g):
        out, vjp = jax.vjp(lambda b_: jemb.coded_lookup(b_, toks), b)
        return out, vjp(g)[0]

    out_j, dj = fwd_bwd(jb, jnp.asarray(g32).astype(dtype))
    tb = torch.from_numpy(banks32).to(getattr(torch, dtype))
    tb.requires_grad_(True)
    out_t = temb.coded_lookup(tb, torch.from_numpy(toks))
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    lanes = torch.int16 if dtype == "bfloat16" else torch.int32
    assert np.array_equal(np.asarray(out_j).view(bits),
                          out_t.detach().view(lanes).numpy().view(bits))
    use_par = temb._plan_use_parity(torch.from_numpy(toks).long() % nb, nb)
    assert use_par.float().mean() > 0.3          # degraded reads served
    out_t.backward(torch.from_numpy(g32).to(tb.dtype))
    assert np.array_equal(np.asarray(dj).view(bits),
                          tb.grad.view(lanes).numpy().view(bits))
    assert tb.grad.dtype == tb.dtype


# ------------------------------------------------- loss_fn and gradients
def _loss_and_grads(arch, *, compute="float32", remat=True, q_chunk=0,
                    policy="full"):
    jc, _ = _cfgs(arch, compute_dtype=compute, remat_policy=policy)
    toks = _tokens(jc.vocab)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jc, p, b, remat=remat, q_chunk=q_chunk)))(
        _jax_init(arch), {"tokens": jnp.asarray(toks)})
    return (float(jl), jg), _port_loss_and_grads(
        arch, compute=compute, remat=remat, q_chunk=q_chunk, policy=policy)


def _port_loss_and_grads(arch, *, compute="float32", remat=True, q_chunk=0,
                         policy="full"):
    _, tc = _cfgs(arch, compute_dtype=compute, remat_policy=policy)
    toks = _tokens(tc.vocab)
    tp = convert.params_from_jax(tc, _jax_init(arch), "cpu")
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl = tlm.loss_fn(tc, tp, {"tokens": torch.from_numpy(toks)},
                     remat=remat, q_chunk=q_chunk)
    tg = torch.autograd.grad(tl, leaves)
    return float(tl.detach()), tadamw.tree_unflatten(tp, list(tg))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_every_grad_match_jax(arch):
    """``loss_fn`` and every gradient leaf of each dense config (tied
    coded embedding with QKV bias, untied head, coded embedding with an
    untied head, LayerNorm with a GELU MLP), f32 compute, remat "full".
    For qwen also remat off and the "dots" policy: recompute changes no
    value (in JAX as in the port), so each is held against JAX's
    ``loss_fn`` and is bit-equal to the port's "full"."""
    (jl, jg), (tl, tg) = _loss_and_grads(arch)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    _assert_tree_close(jg, tg, rel=GRAD_TOL, what=arch)
    if arch != "qwen2.5-3b":
        return
    for kw in (dict(remat=False), dict(policy="dots")):
        tl_v, tg_v = _port_loss_and_grads(arch, **kw)
        np.testing.assert_allclose(tl_v, jl, **LOSS_TOL)
        _assert_tree_close(jg, tg_v, rel=GRAD_TOL, what=str(kw))
        assert tl_v == tl
        for a, b in zip(tree_leaves(tg_v), tree_leaves(tg)):
            assert torch.equal(a, b)


def test_loss_fn_and_grads_at_bf16_compute():
    """bf16 compute over f32 master params (qwen: the coded lookup runs on
    the cast bf16 bits and its gradient accumulates in bf16)."""
    (jl, jg), (tl, tg) = _loss_and_grads("qwen2.5-3b", compute="bfloat16")
    assert abs(tl - jl) <= BF16_LOSS_TOL
    _assert_tree_close(jg, tg, rel=BF16_GRAD_TOL, what="bf16")
    assert all(g.dtype == torch.float32 for g in tree_leaves(tg))


def test_q_chunk_matches_jax():
    """Query chunks (2 chunks of 8, remat off) against JAX's
    ``mha_chunked`` path at the same setting."""
    (jl, jg), (tl, tg) = _loss_and_grads("qwen2.5-3b", remat=False,
                                         q_chunk=8)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    _assert_tree_close(jg, tg, rel=GRAD_TOL, what="q_chunk")


# ------------------------------------------------------------------ AdamW
def _opt_tree(rng):
    """A params-shaped tree with leaves that decay and leaves that do not
    (JAX's mask tests the last key: scale, bias)."""
    shapes = {"embed": {"banks": (8, 4, 6)}, "final_norm": {"scale": (6,)},
              "blocks": {"attn": {"wq": (2, 6, 6), "bq": (2, 6)},
                         "norm1": {"scale": (2, 6), "bias": (2, 6)}}}
    return jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("clip", ["clipped", "unclipped"])
def test_adamw_update_matches_jax(clip):
    """3 steps of ``adamw_update`` from the same gradients: step 1 in the
    warmup, steps 2-3 on the cosine; clipping active (clip_norm 0.1) or
    not; the decay mask by leaf name; the norm before clipping."""
    rng = np.random.default_rng(5)
    cfg_kw = dict(OPT, clip_norm=0.1 if clip == "clipped" else 1e6)
    jcfg, tcfg = jadamw.OptConfig(**cfg_kw), tadamw.OptConfig(**cfg_kw)
    params = _opt_tree(rng)
    jp, jst = params, jadamw.adamw_init(params)
    tp = convert.params_from_jax(tget_config("yi-6b"), params, "cpu")
    tst = tadamw.adamw_init(tp)
    update = jax.jit(jadamw.adamw_update, static_argnums=0)
    for step in range(3):
        grads = _opt_tree(rng)
        grads["final_norm"]["scale"][:] = 0.0      # decay-free, no grad
        jp, jst, jn = update(jcfg, grads, jst, jp)
        tg = convert.params_from_jax(tget_config("yi-6b"), grads, "cpu")
        tp, tst, tn = tadamw.adamw_update(tcfg, tg, tst, tp)
        np.testing.assert_allclose(float(tn), float(jn), **LOSS_TOL)
        assert int(tst.step) == int(jst.step) == step + 1
        for jtree, ttree in ((jp, tp), (jst.m, tst.m), (jst.v, tst.v)):
            jn_, tn_ = _named(jtree), {"/".join(p): t for p, t in
                                       tree_leaves_with_path(ttree)}
            for name, a in jn_.items():
                np.testing.assert_allclose(tn_[name].numpy(), a,
                                           err_msg=name, **OPT_TOL)
    assert (float(tn) > tcfg.clip_norm) == (clip == "clipped")


def test_cosine_schedule_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 30, 50, 80):
        j = float(jadamw.cosine_schedule(jadamw.OptConfig(**cfg),
                                         jnp.int32(step)))
        t = float(tadamw.cosine_schedule(tadamw.OptConfig(**cfg), step))
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


# -------------------------------------------------------- make_train_step
@functools.lru_cache(maxsize=None)
def _jax_step(arch, n_micro):
    jc, _ = _cfgs(arch, compute_dtype="float32")
    return jax.jit(jsteps.make_train_step(jc, jadamw.OptConfig(**OPT),
                                          n_micro=n_micro))


def _jax_run(arch, n_micro, batches):
    jp = _jax_init(arch)
    jst = jadamw.adamw_init(jp)
    out = []
    for b in batches:
        jp, jst, m = _jax_step(arch, n_micro)(jp, jst,
                                              {"tokens": jnp.asarray(b)})
        out.append({k: float(v) for k, v in m.items()})
    return jp, jst, out


@pytest.mark.parametrize("arch,n_micro", [("qwen2.5-3b", 2), ("yi-6b", 1)])
def test_train_step_matches_jax(arch, n_micro):
    """3 steps of ``make_train_step`` from the same params on the same
    batches: loss, grad norm, lr_step, the moments and every param leaf;
    with ``n_micro=2`` the f32-accumulated gradients of two microbatches
    (qwen at ``n_micro=1``: the ``Trainer`` case below)."""
    jc, tc = _cfgs(arch, compute_dtype="float32")
    batches = [_tokens(jc.vocab, seed=10 + i) for i in range(3)]
    jp, jst, jm = _jax_run(arch, n_micro, batches)
    tp = convert.params_from_jax(tc, _jax_init(arch), "cpu")
    tst = tadamw.adamw_init(tp)
    step = tsteps.make_train_step(tc, tadamw.OptConfig(**OPT),
                                  n_micro=n_micro)
    for b, m in zip(batches, jm):
        tp, tst, tm = step(tp, tst, {"tokens": torch.from_numpy(b)})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), m[k], **LOSS_TOL)
        assert float(tm["lr_step"]) == m["lr_step"]
    _assert_tree_close(jst.m, tst.m, rel=GRAD_TOL, what="m")
    _assert_tree_close(jst.v, tst.v, rel=GRAD_TOL, what="v")
    _assert_tree_close(jp, tp, atol=_param_tol(3), what="params")


def test_microbatches_equal_one_batch_in_the_port():
    """``n_micro=2`` against ``n_micro=1`` in the port: the mean of two
    half-batch losses and gradients is the whole batch's."""
    _, tc = _cfgs("granite-20b", compute_dtype="float32")
    toks = torch.from_numpy(_tokens(tc.vocab, seed=4))
    out = []
    for n in (1, 2):
        tp = tlm.init_params(tc, seed=1, device="cpu", dtype=torch.float32)
        step = tsteps.make_train_step(tc, tadamw.OptConfig(**OPT), n_micro=n)
        out.append(step(tp, tadamw.adamw_init(tp), {"tokens": toks}))
    (p1, _, m1), (p2, _, m2) = out
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), **LOSS_TOL)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(b.detach(), a.detach(), rtol=0,
                                   atol=_param_tol(1))


# --------------------------------------------------------- data pipeline
@pytest.mark.parametrize("seed,n_hosts", [(0, 1), (7, 2), (123, 4)])
def test_make_batch_and_prefetcher_bit_for_bit(seed, n_hosts):
    for host in range(n_hosts):
        kw = dict(vocab=5000, batch=8, seq_len=24, seed=seed,
                  n_hosts=n_hosts, host_id=host)
        jcfg, tcfg = jdata.DataConfig(**kw), tdata.DataConfig(**kw)
        for step in (0, 1, 17):
            assert np.array_equal(tdata.make_batch(tcfg, step)["tokens"],
                                  jdata.make_batch(jcfg, step)["tokens"])
    pf = tdata.Prefetcher(tdata.TokenStream(tcfg))
    try:
        for step in (0, 1, 2, 5, 6, 1):            # in order, then jumps
            assert np.array_equal(pf.get(step)["tokens"],
                                  jdata.make_batch(jcfg, step)["tokens"])
    finally:
        pf.stop()
    assert pf._thread is None


# ------------------------------------------------------------ compression
def test_compress_int8_bit_for_bit():
    rng = np.random.default_rng(9)
    tree = {"a": rng.normal(size=(3, 300)).astype(np.float32),
            "b": {"c": np.zeros((256,), np.float32),
                  "d": (rng.normal(size=(7, 5)) * 1e-3).astype(np.float32)}}
    for x in jax.tree.leaves(tree):
        jq, js = jcompress.compress_int8(jnp.asarray(x))
        tq, ts = tcompress.compress_int8(torch.from_numpy(x))
        assert np.array_equal(np.asarray(jq), tq.numpy())
        assert np.array_equal(np.asarray(js).view(np.uint32),
                              ts.numpy().view(np.uint32))
        jd = jcompress.decompress_int8(jq, js, x.shape, jnp.float32)
        td = tcompress.decompress_int8(tq, ts, x.shape, torch.float32)
        assert np.array_equal(np.asarray(jd), td.numpy())
    jcomp, jres, jdef = jcompress.compress_tree(jax.tree.map(jnp.asarray,
                                                             tree))
    tt = jax.tree.map(torch.from_numpy, tree)
    tcomp, tres, tdef = tcompress.compress_tree(tt)
    for (jq, js), (tq, ts) in zip(jcomp, tcomp):
        assert np.array_equal(np.asarray(jq), tq.numpy())
    _assert_tree_close(jres, tres, atol=0.0, what="residual")
    shapes = [x.shape for x in jax.tree.leaves(tree)]
    back = tcompress.decompress_list(tcomp, shapes, [torch.float32] * 3, tdef)
    jback = jcompress.decompress_list(jcomp, shapes, [jnp.float32] * 3, jdef)
    _assert_tree_close(jback, back, atol=0.0, what="decompressed")


# ------------------------------------------- checkpoint and convert
def test_checkpoint_and_convert_interoperate_with_jax(tmp_path):
    """A JAX checkpoint of params and ``OptState`` restores in the port
    (onto a device, with or without a ``like`` tree) and the port's
    restores in JAX, bit for bit, bf16 leaves included; ``convert``
    carries the ``OptState`` both ways."""
    _, tc = _cfgs("qwen2.5-3b")
    jp = _jax_init("qwen2.5-3b")
    jst = jadamw.adamw_init(jp)
    rng = np.random.default_rng(2)
    jst = jadamw.OptState(jnp.int32(5), *(
        jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                     t) for t in (jst.m, jst.v)))
    tree = {"params": jp, "opt": jst,
            "bf16": jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16)}
    jckpt.save(5, tree, str(tmp_path / "j"))
    back = tckpt.restore(str(tmp_path / "j"), device="cpu")
    tst = convert.opt_state_from_jax(tc, jax.device_get(jst), "cpu")
    tparams = convert.params_from_jax(tc, jp, "cpu")
    like = {"params": tparams, "opt": tst,
            "bf16": torch.zeros(3, 4, dtype=torch.bfloat16)}
    for got in (back, tckpt.restore(str(tmp_path / "j"), like, device="cpu")):
        opt = got["opt"]
        if isinstance(opt, dict):
            opt = tadamw.OptState(opt["step"], opt["m"], opt["v"])
        assert int(opt.step) == 5 and opt.step.dtype == torch.int32
        _assert_tree_close(jp, got["params"], atol=0.0)
        _assert_tree_close(jst.m, opt.m, atol=0.0)
        _assert_tree_close(jst.v, opt.v, atol=0.0)
        assert got["bf16"].dtype == torch.bfloat16
        assert np.array_equal(got["bf16"].view(torch.int16).numpy()
                              .view(np.uint16),
                              np.asarray(tree["bf16"]).view(np.uint16))
    tckpt.save(6, got, str(tmp_path / "t"))
    jback = jckpt.restore(str(tmp_path / "t"), jax.tree.map(jnp.asarray,
                                                            tree))
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a),
                                                     np.asarray(b))
    np_opt = jadamw.OptState(*convert.opt_state_to_numpy(tst))
    assert np_opt.step.dtype == np.int32 and int(np_opt.step) == 5
    for a, b in zip(jax.tree.leaves(np_opt), jax.tree.leaves(jst)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(tparams)),
                    jax.tree.leaves(jp)):
        assert np.array_equal(a, np.asarray(b))


# ---------------------------------------------------------------- Trainer
def _tc(d, **kw):
    base = dict(steps=6, log_every=100, ckpt_every=0, ckpt_dir=str(d),
                global_batch=B, seq_len=S)
    base.update(kw)
    return ttrainer.TrainConfig(**base)


def test_trainer_matches_looped_jax_step(tmp_path):
    """The port's ``Trainer`` started from JAX's init (a JAX checkpoint at
    step 0 in its directory) runs 6 steps on its prefetched batches:
    every step's loss and grad norm and the final params equal the looped
    JAX ``train_step`` on JAX's ``make_batch``."""
    jc, tc = _cfgs("qwen2.5-3b", compute_dtype="float32")
    jp = _jax_init("qwen2.5-3b")
    jckpt.save(0, {"params": jp, "opt": jadamw.adamw_init(jp)},
               str(tmp_path))
    dcfg = jdata.DataConfig(vocab=jc.vocab, batch=B, seq_len=S, seed=0)
    batches = [jdata.make_batch(dcfg, s)["tokens"] for s in range(6)]
    jpf, _, jm = _jax_run("qwen2.5-3b", 1, batches)
    tr = ttrainer.Trainer(tc, _tc(tmp_path),
                          opt_cfg=tadamw.OptConfig(**OPT), device="cpu")
    out = tr.run()
    assert out["events"] == ["restored step 0"]
    assert [m["step"] for m in tr.metrics_log] == list(range(6))
    for t, j in zip(tr.metrics_log, jm):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(t[k], j[k], **LOSS_TOL)
    _assert_tree_close(jpf, out["params"], atol=_param_tol(6), what="params")


def test_fault_recovery_is_bit_identical(tmp_path):
    """A run with a fault injected at step 3 and a checkpoint every 2
    steps restores step 2, replays with the prefetcher restarted there,
    and ends with the params and ``OptState`` of an uninterrupted run,
    bit for bit. Straggler detection is off (its factor infinite): a step
    slowed by the host's load would add a ``straggler`` event to the list
    asserted here; ``test_straggler_detection_with_a_patched_clock`` holds
    that logic on a patched clock."""
    _, tc = _cfgs("qwen2.5-3b")
    outs = []
    for name, plan in (("a", None), ("b", ttrainer.FaultPlan([3]))):
        tr = ttrainer.Trainer(tc, _tc(tmp_path / name, ckpt_every=2, keep=2,
                                      straggler_factor=float("inf")),
                              opt_cfg=tadamw.OptConfig(**OPT), device="cpu")
        outs.append((tr.run(fault_plan=plan), tr))
    (a, ta), (b, tb) = outs
    assert b["events"] == ["recovering (injected fault at step 3)",
                           "restored step 2"]
    assert [m["step"] for m in tb.metrics_log] == [0, 1, 2, 2, 3, 4, 5]
    assert tb.metrics_log[-1]["loss"] == ta.metrics_log[-1]["loss"]
    for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
        assert torch.equal(x, y)
    assert int(a["opt"].step) == int(b["opt"].step) == 6
    for x, y in zip(tree_leaves(a["opt"].m) + tree_leaves(a["opt"].v),
                    tree_leaves(b["opt"].m) + tree_leaves(b["opt"].v)):
        assert torch.equal(x, y)
    assert sorted(os.listdir(tmp_path / "b")) == ["step_000000004",
                                                  "step_000000006"]


def test_straggler_detection_with_a_patched_clock(tmp_path, monkeypatch):
    """A step 10x the EMA of the steps before it is a straggler; the
    first step (here 10x too) never seeds the watermark."""
    durations = iter([1.0, 0.1, 0.1, 0.1, 0.1, 1.0, 0.1, 0.1])
    clock = {"t": 0.0, "start": True}

    def fake():
        if not clock["start"]:
            clock["t"] += next(durations)
        clock["start"] = not clock["start"]
        return clock["t"]

    monkeypatch.setattr(ttrainer, "perf_counter", fake)
    _, tc = _cfgs("yi-6b")
    tr = ttrainer.Trainer(tc, _tc(tmp_path, steps=8, global_batch=2, seq_len=8),
                          device="cpu")
    out = tr.run()
    assert out["stragglers"] == 1
    assert [e.split()[:2] for e in out["events"]] == [["straggler",
                                                       "step=5"]]


def test_trainer_device_mesh_and_default_checkpoint_dir():
    """The card unless named (raises here), no mesh beyond one device
    without a process group (no single-device fallback), and a fresh
    checkpoint directory when none is named."""
    _, tc = _cfgs("yi-6b")
    base = ttrainer.TrainConfig(steps=1)
    assert base.ckpt_dir is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrainer.Trainer(tc, base)
    with pytest.raises(ValueError, match="process group"):
        ttrainer.Trainer(tc, base, (2, 1), device="cpu")
    a = ttrainer.Trainer(tc, base, (1, 1), device="cpu")
    b = ttrainer.Trainer(tc, base, device="cpu")
    try:
        assert a.ckpt_dir != b.ckpt_dir and os.listdir(a.ckpt_dir) == []
    finally:
        for d in (a.ckpt_dir, b.ckpt_dir):
            shutil.rmtree(d)


def test_launch_train_reduced_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch qwen2.5-3b --reduced
    --device cpu``: trains, checkpoints, recovers from ``--fail-at`` and
    leaves the determinism setting as it found it."""
    was = torch.are_deterministic_algorithms_enabled()
    out = tlaunch.main(["--arch", "qwen2.5-3b", "--reduced", "--device",
                        "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
                        "--ckpt", str(tmp_path), "--ckpt-every", "2",
                        "--fail-at", "3"])
    assert torch.are_deterministic_algorithms_enabled() == was
    assert np.isfinite(out["final_loss"])
    assert "restored step 2" in out["events"]
    assert tckpt.latest_step(str(tmp_path)) == 4
    assert "done: final_loss=" in capsys.readouterr().out
    with pytest.raises(ValueError, match="process group"):
        tlaunch.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                      "--mesh-model", "2"])
