"""The audio encoder-decoder (whisper-tiny) of the port against the JAX
package on the CPU, reduced, at ``compute_dtype="float32"``: the config,
``convert`` of the audio tree, ``encode``, ``cross_attention_block``,
prefill and greedy decode over the ring cache (the cross-attention K/V
cached), the learned positions' clamp past the table, and the port's
``Server`` against per-request JAX prefill and decode (JAX's own
``Server`` sizes the cross K/V to no frames and fails at its first
install, so it cannot be the reference). The params are drawn with numpy
from a seed in the tree and shapes of JAX's ``init_params``, at its
scales (``test_torch_train_families.draw_like``), every norm's scale and
bias and the QKV biases too (JAX's init makes them 1 and 0, which would
hide where a bias is added), and carried across by
``convert.params_from_jax``; JAX's functions are compiled at XLA's
backend optimization level 0 (the same graphs, a third of the compile
time).

Tolerances at f32 (the frameworks sum in different orders): the encoder
output and the cross-attention within 1e-5 of their largest magnitude;
logits within rtol = atol = 1e-4; greedy and served tokens identical;
``convert`` bit for bit."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import layers as jly
from repro.models import lm as jlm
from repro_torch.configs.base import get_config as tget_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.models import layers as tly
from repro_torch.models import lm as tlm
from repro_torch.runtime import server as tserver
from test_torch_train_families import FAST_COMPILE, draw_like

NAME = "whisper-tiny"
REL = 1e-5
TOL = dict(rtol=1e-4, atol=1e-4)
POS_ROWS = 24                      # the learned position table's rows
SC = dict(n_slots=2, max_prompt=8, max_seq=24, max_new_tokens=6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: one intra-op thread each keeps six test
    workers from oversubscribing the cores (torch starts one a core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**extra):
    return tuple(dataclasses.replace(g(NAME).reduced(),
                                     compute_dtype="float32", **extra)
                 for g in (jget_config, tget_config))


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jit(fn, *static, **kw):
    """``fn`` jitted with its leading (config) arguments bound."""
    return jax.jit(functools.partial(fn, *static, **kw),
                   compiler_options=FAST_COMPILE)


@functools.lru_cache(maxsize=None)
def _model(rows=POS_ROWS):
    """The configs and one param tree in both packages, the norms and
    QKV biases redrawn (f32, as JAX keeps them)."""
    jc, tc = _cfgs()
    shapes = jax.eval_shape(lambda k: jlm.init_params(jc, k, max_seq=rows),
                            jax.random.key(0))
    rng = np.random.default_rng(1)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("scale", "bias", "bq", "bk", "bv"):
                mean = 1.0 if k == "scale" else 0.0
                out[k] = rng.normal(mean, 0.2, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    host = walk(draw_like(shapes))
    jp = jax.tree.map(jnp.asarray, host)
    return jc, tc, host, jp, params_from_jax(tc, host, "cpu")


def _frames(cfg, b, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def _close_rel(a, b, rel=REL):
    a, b = np.asarray(a), b.detach().numpy()
    err = np.abs(a - b).max()
    assert err <= rel * np.abs(a).max(), (err, np.abs(a).max())


# ---------------------------------------------------------------- config
def test_config_copies_jax():
    """Every field of whisper-tiny has JAX's value, full and reduced, and
    the analytic parameter counts agree."""
    for j, t in ((jget_config(NAME), tget_config(NAME)),
                 (jget_config(NAME).reduced(), tget_config(NAME).reduced())):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.n_params() == j.n_params()
    assert tget_config(NAME).enc_frames == 1500
    assert tget_config(NAME).reduced().enc_frames == 32


def test_convert_and_init_carry_the_audio_tree():
    """``params_from_jax`` carries JAX's audio tree (``enc_blocks``,
    ``enc_final_norm``, ``pos_embed``, ``xattn`` with its biases) leaf for
    leaf, bit for bit, and back; the port's own init has JAX's leaves and
    shapes."""
    jc, tc, host, _, tp = _model()
    names = {"/".join(str(getattr(k, "key", k)) for k in p): a for p, a in
             jax.tree_util.tree_leaves_with_path(host)}
    for want in ("enc_blocks/attn/bk", "enc_final_norm/bias", "pos_embed",
                 "blocks/xattn/bq", "blocks/xattn/bv", "blocks/norm3/scale"):
        assert want in names, want
    back = params_to_numpy(tp)
    for name, a in names.items():
        node = back
        for k in name.split("/"):
            node = node[k]
        assert node.dtype == a.dtype and np.array_equal(node, a), name
    own = tlm.init_params(tc, seed=0, device="cpu", dtype=torch.float32,
                          max_seq=POS_ROWS)
    own_names = {"/".join(p): tuple(t.shape) for p, t in
                 zip(*_paths(own))}
    assert own_names == {n: a.shape for n, a in names.items()}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = ([], [])
        for k in sorted(tree):
            ps, ts = _paths(tree[k], prefix + (k,))
            out[0].extend(ps)
            out[1].extend(ts)
        return out
    return [prefix], [tree]


# ------------------------------------------------------------ the layers
def test_encode_matches_jax():
    """The encoder over seeded frames: within 1e-5 of its largest
    magnitude."""
    jc, tc, _, jp, tp = _model()
    frames = _frames(jc, 2)
    want = _jit(jlm.encode, jc, remat=False)(jp, jnp.asarray(frames))
    with torch.no_grad():
        got = tlm.encode(tc, tp, _t(frames), remat=False)
    _close_rel(want, got)


def test_cross_attention_block_matches_jax():
    """Layer 0's cross-attention over seeded decoder states and encoder
    output (biases nonzero): within 1e-5 of its largest magnitude."""
    jc, tc, _, jp, tp = _model()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, jc.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, jc.enc_frames, jc.d_model)).astype(np.float32)
    jx = jax.tree.map(lambda a: a[0], jp["blocks"]["xattn"])
    want = jly.cross_attention_block(jc, jx, jnp.asarray(x), jnp.asarray(enc))
    got = tly.cross_attention_block(tc, tlm.layer_params(
        tp["blocks"]["xattn"], 0), _t(x), _t(enc))
    _close_rel(want, got)


# ------------------------------------------------------ prefill + decode
def _decode_both(jc, tc, jp, tp, toks, frames, max_seq, steps):
    """JAX's and the port's prefill, then ``steps`` greedy decode steps
    each from its own tokens: [(JAX logits, port logits)], the caches."""
    jl, jcache = _jit(jlm.prefill, jc, max_seq=max_seq)(
        jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    with torch.no_grad():
        tl, tcache = tlm.prefill(tc, tp, _t(toks).long(), max_seq=max_seq,
                                 frames=_t(frames))
    out = [(jl, tl)]
    jdec = _jit(jlm.decode_step, jc)
    for _ in range(steps):
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1)
        assert np.array_equal(np.asarray(jtok), ttok.numpy())
        jl, jcache = jdec(jp, jtok, jcache)
        with torch.no_grad():
            tl, tcache = tlm.decode_step(tc, tp, ttok, tcache)
        out.append((jl, tl))
    return out, jcache, tcache


def test_prefill_and_decode_match_jax():
    """Prefill (the cross K/V cached with their biases) and 4 greedy
    decode steps: logits within 1e-4 at every step, the same tokens, the
    caches' K/V and cross K/V within 1e-4."""
    jc, tc, _, jp, tp = _model()
    toks = np.random.default_rng(4).integers(0, 256, (2, 8))
    out, jcache, tcache = _decode_both(jc, tc, jp, tp, toks,
                                       _frames(jc, 2), 16, 4)
    for jl, tl in out:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["xk"].shape == (jc.n_layers, 2, jc.enc_frames, jc.n_kv,
                                  jc.head_dim)
    for k in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL)
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()


def test_learned_positions_clamp_past_the_table():
    """With a position table of 8 rows, a prompt of 6 and 6 decode steps
    (positions 6..11) read its last row past position 7, as JAX clamps:
    logits within 1e-4 at every step; the port's embedding at position
    11 is the one at position 7."""
    rows = 8
    jc, tc, host, _, _ = _model()
    host = dict(host, pos_embed=host["pos_embed"][:rows])
    jp = jax.tree.map(jnp.asarray, host)
    tp = params_from_jax(tc, host, "cpu")
    toks = np.random.default_rng(5).integers(0, 256, (2, 6))
    out, _, tcache = _decode_both(jc, tc, jp, tp, toks, _frames(jc, 2, 2),
                                  16, 6)
    for jl, tl in out:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["pos"].tolist() == [12, 12]
    tok = torch.tensor([[3]])
    at = {p: tlm._embed(tc, tp, tok, torch.float32, torch.tensor([[p]]))
          for p in (7, 11, 100)}
    assert torch.equal(at[7], at[11]) and torch.equal(at[7], at[100])


# ------------------------------------------------------------ the server
def _jax_per_request(jc, jp, prompt, n_frames):
    """One request through JAX's prefill and decode alone, as the server
    pads it: left-padded with 0 to max_prompt, zero frames."""
    toks = [0] * (SC["max_prompt"] - len(prompt)) + prompt
    frames = jnp.zeros((1, n_frames, jc.d_model), jnp.float32)
    logits, cache = _jit(jlm.prefill, jc, max_seq=SC["max_seq"])(
        jp, {"tokens": jnp.asarray([toks], jnp.int32), "frames": frames})
    out = [int(jnp.argmax(logits[0]))]
    dec = _jit(jlm.decode_step, jc)
    while len(out) < SC["max_new_tokens"]:
        logits, cache = dec(jp, jnp.asarray([out[-1]], jnp.int32), cache)
        out.append(int(jnp.argmax(logits[0])))
    return out


def test_server_matches_per_request_jax():
    """The port's ``Server`` (2 slots, 5 requests, so slots are reused)
    serves every request the tokens of JAX's prefill and decode run on
    that request alone with the server's zero frames (1, max(enc_frames,
    8), d_model); its ring cache holds cross K/V of that many frames."""
    jc, tc, _, jp, tp = _model()
    rng = np.random.default_rng(6)
    prompts = [[int(t) for t in rng.integers(1, 256, size=3 + i % 4)]
               for i in range(5)]
    srv = tserver.Server(tc, tserver.ServeConfig(**SC), tp, device="cpu")
    assert not srv.pooled
    n_frames = max(jc.enc_frames, 8)
    assert srv.cache["xk"].shape[2] == n_frames
    reqs = [tserver.Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    for r in reqs:
        assert r.done and r.out == _jax_per_request(jc, jp, r.prompt,
                                                    n_frames), r.rid


def test_prefill_needs_frames():
    """An encoder-decoder's prefill without frames raises, naming them."""
    _, tc, _, _, tp = _model()
    with pytest.raises(ValueError, match="frames"):
        tlm.prefill(tc, tp, torch.zeros(1, 4, dtype=torch.long))


def test_launch_serve_reduced_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch whisper-tiny --reduced
    --device cpu``: every request is served from the ring cache."""
    tlaunch_serve.main(["--arch", NAME, "--reduced", "--device", "cpu",
                        "--requests", "3", "--slots", "2", "--max-new", "4",
                        "--max-prompt", "16", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and "ring cache" in out
