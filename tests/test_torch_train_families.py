"""Training every non-dense family in the port against the JAX package on
the CPU: one ``make_train_step`` at f32 from the same params on the same
batch for olmoe-1b-7b and mixtral-8x7b (MoE, the latter with a sliding
window), phi-3-vision-4.2b with patch embeddings, mamba2-2.7b (SSD
mixers), recurrentgemma-9b (RG-LRU superblocks) and whisper-tiny with
frame embeddings, each reduced; per-layer recompute on against off; the
``Trainer`` (tokens only, as JAX's feeds them) with a fault restart; the
audio family's refusal there.

The params are drawn with numpy from a seed in the tree and shapes of
JAX's ``init_params`` (``jax.eval_shape``, no compile), each matrix at
JAX's scale (fan-in ** -0.5; embeddings d ** -0.5), and carried across
by ``convert.params_from_jax``; the leaves JAX's init makes constant
(the SSM's ``A_log``, ``D``, ``dt_bias``, the RG-LRU's ``lam``, every
norm's scale and bias, the QKV biases) are drawn too, so their
gradients and dtypes show; JAX's step is compiled at XLA's backend
optimization level 0 (a third of the compile time, the same graph);
``A_log`` <= 0 keeps every SSD chunk's decay within f32's exp range,
where JAX's gradient is finite (the overflow case is held apart).

Tolerances at f32 (the frameworks sum in different orders):
- the loss and the grad norm within ``LOSS_TOL`` (1e-5 relative);
- every leaf of both moments (the first is (1 - b1) x the clipped
  gradient, the second its square) within ``LEAF_TOL`` (1e-4) of that
  leaf's largest magnitude; the k biases of attention without RoPE
  (whisper's self-, cross- and encoder attention), whose gradient
  softmax cancels exactly (rounding only: measured 3e-10 to 7e-10
  against the layer's wk's 2e-3 to 5e-3), within ``LEAF_TOL`` of the
  largest moment of the layer's wk;
- the updated params, element by element: within ``LEAF_TOL`` of the
  leaf's largest magnitude where JAX's gradient is clear of Adam's eps
  (|g| >= ``CLEAR`` = 100 eps), else within ``lr``. Adam divides each
  moment by its own root mean square + eps, so a gradient near eps turns
  its rounding into a step of a fraction of lr (measured: up to 0.11 lr
  in recurrentgemma's MLP); the first step moves no param by more than
  lr, whatever its gradient.
- recompute on against off in the port: bit for bit;
- the ``Trainer`` with a fault restart against an uninterrupted run: bit
  for bit."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime import steps as jsteps
from repro_torch import convert
from repro_torch.configs.base import get_config as tget_config
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.adamw import tree_leaves, tree_leaves_with_path
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime import trainer as ttrainer

ARCHS = ("olmoe-1b-7b", "mixtral-8x7b", "phi-3-vision-4.2b", "mamba2-2.7b",
         "recurrentgemma-9b", "whisper-tiny")
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
LEAF_TOL = 1e-4
CLEAR = 1e-6                       # 100 x Adam's eps: see the docstring
B, S = 2, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
FAST_COMPILE = {"xla_backend_optimization_level": 0}
# leaves whose gradient softmax cancels (attention without RoPE)
CANCELLING = ("attn/bk", "xattn/bk")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread each keeps six test
    workers from oversubscribing the cores (torch starts one a core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return tuple(dataclasses.replace(g(arch).reduced(),
                                     compute_dtype="float32")
                 for g in (jget_config, tget_config))


def _redraw(tree, a_log_max=0.0, seed=0):
    """The leaves JAX's init makes constant, redrawn (f32); ``A_log`` up
    to ``a_log_max`` (the SSM's fastest decay)."""
    rng = np.random.default_rng(seed)
    draw = {"A_log": lambda s: rng.uniform(-1.0, a_log_max, s),
            "D": lambda s: rng.normal(1.0, 0.5, s),
            "dt_bias": lambda s: rng.normal(0.0, 1.0, s),
            "lam": lambda s: rng.normal(0.5, 1.0, s),
            "scale": lambda s: rng.normal(1.0, 0.2, s),
            "bias": lambda s: rng.normal(0.0, 0.2, s),
            "bq": lambda s: rng.normal(0.0, 0.2, s),
            "bk": lambda s: rng.normal(0.0, 0.2, s),
            "bv": lambda s: rng.normal(0.0, 0.2, s)}

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    draw[k](v.shape).astype(np.float32) if k in draw
                    else np.asarray(v)) for k, v in node.items()}
    return walk(tree)


def draw_like(shapes, seed=0):
    """numpy f32 normals in the tree and shapes of ``shapes`` (JAX's
    ``eval_shape`` of its init), at JAX's init scales."""
    rng = np.random.default_rng(seed)

    def leaf(name, a):
        if name in ("table", "banks"):
            scale = a.shape[-1] ** -0.5
        elif name == "pos_embed":
            scale = 0.02
        elif name == "conv_w":
            scale = 0.1
        elif len(a.shape) >= 2:
            scale = a.shape[-2] ** -0.5
        else:
            return np.zeros(a.shape, np.float32)
        return (rng.standard_normal(a.shape) * scale).astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in node.items()}
    return walk(shapes)


@functools.lru_cache(maxsize=None)
def _init(arch, a_log_max=0.0):
    jc, _ = _cfgs(arch)
    shapes = jax.eval_shape(lambda k: jlm.init_params(jc, k, max_seq=S),
                            jax.random.key(0))
    return _redraw(draw_like(shapes), a_log_max)


def _batch(cfg, seed=0):
    """Tokens and, where the family takes them, patches or frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        out["patches"] = rng.normal(size=(B, cfg.n_patches, cfg.d_model)) \
            .astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.normal(size=(B, cfg.enc_frames, cfg.d_model)) \
            .astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_step(arch, a_log_max=0.0):
    """One jitted JAX step from the shared init: (params, opt, metrics)
    as numpy."""
    jc, _ = _cfgs(arch)
    step = jax.jit(jsteps.make_train_step(jc, jadamw.OptConfig(**OPT)),
                   compiler_options=FAST_COMPILE)
    jp = jax.tree.map(jnp.asarray, _init(arch, a_log_max))
    out = step(jp, jadamw.adamw_init(jp),
               {k: jnp.asarray(v) for k, v in _batch(jc).items()})
    return jax.tree.map(np.asarray, out)


def _port_step(arch, remat=True, a_log_max=0.0, own_init=False):
    """One port step from JAX's init (redrawn), or with ``own_init`` from
    the port's own init with the same redraws (no JAX compile)."""
    _, tc = _cfgs(arch)
    if own_init:
        own = tlm.init_params(tc, seed=0, device="cpu", dtype=torch.float32,
                              max_seq=S)
        host = _redraw(convert.params_to_numpy(own), a_log_max)
    else:
        host = _init(arch, a_log_max)
    tp = convert.params_from_jax(tc, host, "cpu")
    step = tsteps.make_train_step(tc, tadamw.OptConfig(**OPT), remat=remat)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tc).items()}
    return step(tp, tadamw.adamw_init(tp), batch)


def _named(jtree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): a
            for path, a in jax.tree_util.tree_leaves_with_path(jtree)}


def _tnamed(ttree):
    return {"/".join(p): t.detach().numpy() for p, t in
            tree_leaves_with_path(ttree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One f32 step: loss and grad norm within 1e-5 relative, lr_step
    equal, both moments within 1e-4 of each leaf's largest magnitude and
    the updated params within that where the gradient is clear of eps
    (the module docstring has the rest)."""
    jp, jst, jm = _jax_step(arch)
    tp, tst, tm = _port_step(arch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **LOSS_TOL)
    assert float(tm["lr_step"]) == float(jm["lr_step"])
    b1 = tadamw.OptConfig().b1
    jm_, jv, jpn = _named(jst.m), _named(jst.v), _named(jp)
    tm_, tv, tpn = (_tnamed(t) for t in (tst.m, tst.v, tp))
    assert sorted(jpn) == sorted(tpn) == sorted(jm_) == sorted(tm_)
    for name in jpn:
        for what, a, b in (("m", jm_, tm_), ("v", jv, tv)):
            scale = np.abs(a[name]).max()
            if name.endswith(CANCELLING):
                scale = np.abs(a[name.rsplit("/", 1)[0] + "/wk"]).max()
            err = np.abs(a[name] - b[name]).max()
            assert err <= LEAF_TOL * scale, f"{what} {name}: {err}"
        clear = np.abs(jm_[name]) / (1 - b1) >= CLEAR
        diff = np.abs(jpn[name] - tpn[name])
        tol = LEAF_TOL * np.abs(jpn[name]).max()
        assert diff[clear].max(initial=0) <= tol, \
            f"params {name}: {diff[clear].max()} > {tol}"
        assert diff[~clear].max(initial=0) <= OPT["lr"], f"params {name}"


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_off(arch):
    """Per-layer recompute (the hybrid's superblocks, the encoder's
    layers) gives the step without it, bit for bit."""
    p1, s1, m1 = _port_step(arch, remat=True, own_init=True)
    p0, s0, m0 = _port_step(arch, remat=False, own_init=True)
    for k in ("loss", "grad_norm"):
        assert float(m1[k]) == float(m0[k]), k
    for a, b in zip(tree_leaves(p1) + tree_leaves(s1.m),
                    tree_leaves(p0) + tree_leaves(s0.m)):
        assert torch.equal(a, b)


F32_EXP_MAX = 88.72                # exp overflows f32 past this


def test_ssm_gradients_stay_finite_where_a_chunk_decay_overflows(
        monkeypatch):
    """mamba2 with decays fast enough (``A_log`` up to 2.5) that a
    chunk's decay exponent above the diagonal passes f32's exp range:
    the port masks the exponent before ``exp``, so the loss, every
    gradient and every updated param are finite. (JAX selects after the
    product, and its backward pass makes 0 x inf there: its grad norm is
    NaN at such inputs, so the comparison above draws ``A_log`` <= 0.)
    The port's own init, with the same redraws (no JAX compile)."""
    seen = []
    ssd = tssm._ssd_chunked

    def spy(u, la, bm, cm, chunk):
        cum = torch.cumsum(la.detach().float(), 1)
        seen.append(float((cum[:, :, None] - cum[:, None]).max()))
        return ssd(u, la, bm, cm, chunk)

    monkeypatch.setattr(tssm, "_ssd_chunked", spy)
    tp, tst, tm = _port_step("mamba2-2.7b", a_log_max=2.5, own_init=True)
    assert max(seen) > F32_EXP_MAX
    assert np.isfinite(float(tm["loss"]))
    assert np.isfinite(float(tm["grad_norm"]))
    for leaf in tree_leaves(tp) + tree_leaves(tst.m):
        assert bool(torch.isfinite(leaf).all())


def _trainer(cfg, d, **kw):
    tc = ttrainer.TrainConfig(**dict(dict(
        steps=2, log_every=100, ckpt_every=1, keep=2, ckpt_dir=str(d),
        global_batch=B, seq_len=S), **kw))
    return ttrainer.Trainer(cfg, tc, opt_cfg=tadamw.OptConfig(**OPT),
                            device="cpu")


def test_trainer_fault_restart_is_bit_identical(tmp_path):
    """olmoe-1b-7b reduced through the ``Trainer``: two steps with a
    checkpoint after each and a fault at step 1 restore step 1, replay,
    and end with the params and ``OptState`` of an uninterrupted run,
    bit for bit."""
    _, tc = _cfgs("olmoe-1b-7b")
    outs = []
    for name, plan in (("a", None), ("b", ttrainer.FaultPlan([1]))):
        tr = _trainer(tc, tmp_path / name)
        outs.append((tr.run(fault_plan=plan), tr))
    (a, _), (b, tb) = outs
    assert b["events"] == ["recovering (injected fault at step 1)",
                           "restored step 1"]
    assert [m["step"] for m in tb.metrics_log] == [0, 1]
    assert np.isfinite(b["final_loss"])
    for x, y in zip(tree_leaves(a["params"]) + tree_leaves(a["opt"].m)
                    + tree_leaves(a["opt"].v),
                    tree_leaves(b["params"]) + tree_leaves(b["opt"].m)
                    + tree_leaves(b["opt"].v)):
        assert torch.equal(x, y)


def test_trainer_and_launcher_refuse_audio(tmp_path):
    """The ``Trainer`` feeds tokens only (JAX's fails on whisper at its
    first step): it and the launcher refuse the audio family up front,
    naming frames."""
    _, tc = _cfgs("whisper-tiny")
    with pytest.raises(ValueError, match="frames"):
        _trainer(tc, tmp_path)
    with pytest.raises(ValueError, match="frames"):
        tlaunch.main(["--arch", "whisper-tiny", "--reduced", "--device",
                      "cpu", "--ckpt", str(tmp_path)])


def test_train_step_needs_frames_for_audio():
    """An encoder-decoder's batch without frames raises, naming them."""
    _, tc = _cfgs("whisper-tiny")
    tp = tlm.init_params(tc, seed=0, device="cpu", dtype=torch.float32)
    step = tsteps.make_train_step(tc, tadamw.OptConfig(**OPT))
    toks = torch.from_numpy(_batch(tc)["tokens"])
    with pytest.raises(ValueError, match="frames"):
        step(tp, tadamw.adamw_init(tp), {"tokens": toks})
