"""The port's sharding rules against the JAX package's, leaf for leaf:
``param_spec`` over every config's full-width leaves on the production
and small meshes (fsdp on and off, ``moe_ep`` as each config sets it and,
for the MoE configs, on), ``cache_shardings`` (both kv variants, the
decode shapes), ``batch_spec``, ``axes._resolve`` per logical name, and
the local shard shapes ``to_placements`` gives on a fake 256-rank mesh.

JAX's rules read only a mesh's axis names and shape, so they run here
against a duck-typed mesh with no devices; its ``cache_shardings`` wraps
each spec in a ``NamedSharding``, which the test unwraps."""
import dataclasses

import jax
import pytest
import torch

from repro import axes as jaxes
from repro.configs.base import get_config as jget_config
from repro.launch import sharding as jshd
from repro.models import lm as jlm
from repro_torch import axes as taxes
from repro_torch.configs.base import get_config as tget_config
from repro_torch.launch import sharding as tshd
from repro_torch.launch import shapes as tshapes
from repro_torch.models import lm as tlm

ARCHS = ("qwen2.5-3b", "yi-6b", "stablelm-12b", "granite-20b",
         "olmoe-1b-7b", "mixtral-8x7b", "phi-3-vision-4.2b", "mamba2-2.7b",
         "recurrentgemma-9b", "whisper-tiny")
MESHES = ((16, 16), (2, 16, 16), (2, 2), (1, 4), (4, 1))


class DuckMesh:
    """What the rules read of a mesh: its axis names and sizes."""

    def __init__(self, shape):
        self.axis_names = ("pod", "data", "model")[-len(shape):]
        self.shape = dict(zip(self.axis_names, shape))


class _Spec:
    """JAX's ``NamedSharding`` stand-in: the spec, a pytree leaf."""

    def __init__(self, mesh, spec):
        self.spec = spec


def _jax_leaves(tree):
    return [(jshd._path_str(p), tuple(x.shape)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_jax_for_every_full_width_leaf(arch):
    jc, tc = jget_config(arch), tget_config(arch)
    jleaves = sorted(_jax_leaves(jlm.abstract_params(jc, max_seq=4096)))
    tparams = tlm.abstract_params(tc, max_seq=4096)
    tleaves = sorted((n, tuple(x.shape))
                     for n, x in tshd.flatten_with_path(tparams))
    assert tleaves == jleaves
    assert all(x.is_meta for _, x in tshd.flatten_with_path(tparams))
    eps = (tc.moe_ep, True) if tc.family == "moe" else (tc.moe_ep,)
    for shape in MESHES:
        mesh = DuckMesh(shape)
        for fsdp in (True, False):
            for ep in eps:
                for name, s in tleaves:
                    want = tuple(jshd.param_spec(name, s, mesh, fsdp=fsdp,
                                                 moe_ep=ep))
                    got = tshd.param_spec(name, s, mesh, fsdp=fsdp,
                                          moe_ep=ep)
                    assert got == want, (shape, fsdp, ep, name, s)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_jax(arch, monkeypatch):
    monkeypatch.setattr(jshd, "NamedSharding", _Spec)
    jc, tc = jget_config(arch), tget_config(arch)
    for shape_name in ("decode_32k", "long_500k"):
        sh = tshapes.SHAPES[shape_name]
        jcache = jax.eval_shape(lambda: jlm.cache_spec(
            jc, sh.global_batch, sh.seq_len, enc_frames=jc.enc_frames))
        tcache = tshapes.cache_specs(tc, sh)
        for shape in ((16, 16), (2, 16, 16), (2, 2)):
            mesh = DuckMesh(shape)
            for variant in ("auto", "batch_model"):
                want = {jshd._path_str(p): tuple(s.spec) for p, s in
                        jax.tree_util.tree_flatten_with_path(
                            jshd.cache_shardings(jc, jcache, mesh,
                                                 kv_variant=variant))[0]}
                got = {n: x.spec for n, x in tshd.flatten_with_path(
                    tshd.cache_shardings(tc, tcache, mesh,
                                         kv_variant=variant))}
                assert got == want, (shape_name, shape, variant)


def test_batch_spec_matches_jax():
    for shape in MESHES + ((1, 1),):
        mesh = DuckMesh(shape)
        for b in (1, 2, 4, 6, 32, 128, 256):
            assert tshd.batch_spec(mesh, b) == tuple(jshd.batch_spec(mesh, b))


def test_resolve_matches_jax_per_logical_name():
    assert taxes._RULES == jaxes._RULES
    for shape in MESHES + ((1, 1), (8,)):
        mesh = DuckMesh(shape)
        for name in tuple(jaxes._RULES) + (None,):
            for dim in (1, 2, 3, 4, 6, 16, 32, 48, 64, 100, 256, 512):
                assert taxes._resolve(mesh, name, dim) == \
                    jaxes._resolve(mesh, name, dim), (shape, name, dim)


def test_to_placements_local_shapes_on_a_fake_256_rank_mesh():
    """Every full-width qwen2.5-3b and olmoe-1b-7b (``moe_ep``) leaf,
    distributed at its placements on a fake (16, 16) mesh, holds the
    local shape its spec divides it into; a composite spec shards one
    tensor dim over both mesh dims."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        for arch, kw in (("qwen2.5-3b", {}), ("olmoe-1b-7b",
                                             {"moe_ep": True})):
            cfg = dataclasses.replace(tget_config(arch), **kw)
            for name, x in tshd.flatten_with_path(tlm.abstract_params(cfg)):
                spec = tshd.param_spec(name, tuple(x.shape), mesh,
                                       moe_ep=cfg.moe_ep)
                d = distribute_tensor(x, mesh, tshd.to_placements(spec, mesh))
                assert tuple(d.to_local().shape) == tshd.local_shape(
                    tuple(x.shape), spec, mesh), (arch, name, spec)
        x = torch.empty(256, 3, device="meta")
        d = distribute_tensor(x, mesh, tshd.to_placements(
            (("data", "model"), None), mesh))
        assert tuple(d.to_local().shape) == (1, 3)
    finally:
        dist.destroy_process_group()
