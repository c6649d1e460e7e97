"""The port's launch modules against the JAX package's: ``SHAPES``,
``applicable``, ``default_q_chunk`` and the batch and cache specs (meta
tensors against JAX's ``ShapeDtypeStruct``s); and the dry-run's
machinery on fake process groups: the secant against a full-depth FLOP
count, qwen2.5-3b's per-device argument bytes on ``pod16x16`` against a
sum over JAX's ``param_spec``, the collective factors on a hand-built
DTensor matmul, and the CLI's record."""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_config as jget_config
from repro.launch import sharding as jshd
from repro.launch import shapes as jshapes
from repro_torch.configs.base import get_config as tget_config
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import shapes as tshapes
from test_torch_sharding import ARCHS, DuckMesh


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_group():
    """``fake_group(world)``: a fake process group in this process,
    destroyed after the test."""
    yield tdry._fake_group
    if dist.is_initialized():
        dist.destroy_process_group()


def _dtype(x):
    return np.dtype(str(x.dtype).replace("torch.", ""))


def test_shapes_applicable_and_q_chunk_match_jax():
    assert {k: dataclasses.astuple(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    for arch in ARCHS:
        for name in tshapes.SHAPES:
            jc, tc = jget_config(arch), tget_config(arch)
            js, ts = jshapes.SHAPES[name], tshapes.SHAPES[name]
            assert tshapes.applicable(tc, ts) == jshapes.applicable(jc, js)
            assert tshapes.default_q_chunk(tc, ts) == \
                jshapes.default_q_chunk(jc, js)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax_shape_dtype_structs(arch):
    jc, tc = jget_config(arch), tget_config(arch)
    for name, ts in tshapes.SHAPES.items():
        js = jshapes.SHAPES[name]
        if not tshapes.applicable(tc, ts)[0]:
            continue
        want = {jshd._path_str(p): (tuple(x.shape), np.dtype(x.dtype))
                for p, x in jax.tree_util.tree_flatten_with_path(
                    jshapes.input_specs(jc, js))[0]}
        got = tshapes.input_specs(tc, ts)
        leaves = [(n, x) for n, x in _flat(got)]
        assert all(x.is_meta for _, x in leaves)
        assert {n: (tuple(x.shape), _dtype(x)) for n, x in leaves} == want


def _flat(tree, path=""):
    from repro_torch.launch.sharding import flatten_with_path
    return flatten_with_path(tree, path)


def test_secant_equals_the_full_depth_count(fake_group):
    """cost(L) from the probes equals the count at full depth, exactly:
    reduced whisper-tiny (probes 1, 2; full 4) and a reduced hybrid
    (probes 2, 3, 6; full 8) on a fake (2, 2) mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_group(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    shape = tshapes.ShapeSpec("tiny_train", "train", 64, 4)
    cases = ((dataclasses.replace(tget_config("whisper-tiny").reduced(),
                                  enc_layers=1, enc_frames=16), 4),
             (tget_config("recurrentgemma-9b").reduced(), 8))
    for cfg, full in cases:
        counts = {}
        for L in tdry._probe_layers(cfg) + (full,):
            step, args = tdry.lower_cell(tdry._with_layers(cfg, L), shape,
                                         mesh, q_chunk=0)
            counts[L] = float(tdry.run_step(step, args).flops)
        want = counts.pop(full)
        assert want > 0
        got = tdry._reconstruct(dataclasses.replace(cfg, n_layers=full),
                                counts)
        assert got == want, (cfg.name, got, want)


def test_qwen_argument_bytes_on_pod16x16_equal_param_spec(fake_group):
    """Per-device argument bytes of qwen2.5-3b ``train_4k``: the f32
    params and both moments at JAX's ``param_spec`` local shapes, the
    int32 tokens at ``batch_spec``'s, and the int32 step count."""
    mesh = tdry.make_mesh(False)
    jc = jget_config("qwen2.5-3b")
    jmesh = DuckMesh((16, 16))
    from repro.models import lm as jlm
    want = 0
    for p, x in jax.tree_util.tree_flatten_with_path(
            jlm.abstract_params(jc, max_seq=4096))[0]:
        spec = jshd.param_spec(jshd._path_str(p), x.shape, jmesh)
        n = math.prod(s // jshd._axis_size(jmesh, a)
                      for s, a in zip(x.shape, tuple(spec) + (None,) * 9))
        want += 3 * 4 * n
    want += 256 // 16 * 4096 * 4 + 4          # the tokens, the step count
    step, args = tdry.lower_cell(tget_config("qwen2.5-3b"),
                                 tshapes.SHAPES["train_4k"], mesh)
    assert tdry.argument_bytes(args) == want


def test_collective_factors_on_a_hand_built_matmul(fake_group):
    """(8, 16) sharded on its columns times (16, 32) on its rows: a
    partial (8, 32) f32 product; its all-reduce counts 2x its output,
    the reduce-scatter to rows 1x its input, an all-gather 1x its output,
    and the mm its local FLOPs."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    fake_group(4)
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    x = distribute_tensor(torch.empty(8, 16, device="meta"), mesh, [Shard(1)])
    w = distribute_tensor(torch.empty(16, 32, device="meta"), mesh,
                          [Shard(0)])
    with tdry._Tally() as t:
        y = x @ w
        assert y.placements == (Partial(),)
        y.redistribute(mesh, [Replicate()])
    assert t.flops == 2 * 8 * 4 * 32
    assert t.coll == {"all-reduce": 2.0 * 8 * 32 * 4}
    with tdry._Tally() as t:
        z = y.redistribute(mesh, [Shard(0)])
        z.redistribute(mesh, [Replicate()])
    assert t.coll == {"reduce-scatter": 8 * 32 * 4.0,
                      "all-gather": 8 * 32 * 4.0}


def test_dryrun_cli_writes_a_record_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape
    train_4k``: status ok on meta tensors, the H100 roofline, the secant
    equal to the full-depth count."""
    tdry.main(["--arch", "qwen2.5-3b", "--shape", "train_4k", "--out",
               str(tmp_path)])
    assert "all cells OK" in capsys.readouterr().out
    assert not dist.is_initialized()
    rec = json.loads((tmp_path / "qwen2.5-3b_train_4k_pod16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["fits_hbm_80g"]
    r = rec["roofline"]
    assert r["chips"] == 256
    assert r["t_compute_s"] == r["flops_per_dev"] / 989.4e12
    assert r["t_memory_s"] == r["bytes_per_dev"] / 3.35e12
    assert r["t_collective_s"] == r["coll_bytes_per_dev"] / 450e9
    assert rec["cost"]["flops"] == rec["full_pass"]["flops"] > 0


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b",
                                  "recurrentgemma-9b"])
def test_prefill_in_query_chunks_equals_unchunked(arch):
    """``prefill(q_chunk=8)`` (the dry-run's prefill cells stream their
    queries, as JAX's prefill does) against the unchunked prefill at f32:
    logits and every cache leaf within 1e-5 (a window included)."""
    from repro_torch.launch.sharding import flatten_with_path
    from repro_torch.models import lm
    cfg = dataclasses.replace(tget_config(arch).reduced(),
                              compute_dtype="float32")
    params = lm.cast_params(cfg, lm.init_params(
        cfg, seed=0, device="cpu", dtype=torch.float32), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 32)))
    want = lm.prefill(cfg, params, tokens, max_seq=40)
    got = lm.prefill(cfg, params, tokens, max_seq=40, q_chunk=8)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    for (name, a), (_, b) in zip(flatten_with_path(got[1]),
                                 flatten_with_path(want[1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
