"""Production mesh definitions (``repro.launch.mesh`` counterpart).

Every mesh is a FUNCTION over the initialized process group, never a
module-level constant, so importing this module touches no device
state. The shapes and axis names are the JAX package's, so a dry-run
record compares with JAX's cell by cell:

  single-pod:  (data=16, model=16)          — FSDP/batch x TP
  multi-pod:   (pod=2, data=16, model=16)   — ``pod`` is outer data
               parallelism; it composes with ``data`` for the global
               batch dimension.

A mesh's size must equal the process group's world size: a mismatch
raises ``ValueError`` naming both, and a mesh of more than one device
with no process group raises too (there is no single-device fallback).
A mesh lives on ``"cuda"`` unless the caller names ``"cpu"``. The
sweep's mesh (``make_sweep_mesh``) is the list of devices one process
lays the point axis over, not a process-group mesh.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def _device_type(device) -> str:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: a mesh lives on the card; pass "
                "device='cpu' for a CPU (gloo or fake) process group")
        return "cuda"
    return torch.device(device).type


def init_mesh(shape: Sequence[int], names: Sequence[str], *, device=None):
    """A ``DeviceMesh`` of ``shape`` with axis ``names`` over the
    process group, which must be initialized with a world size equal to
    the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = tuple(int(s) for s in shape), tuple(names)
    n = math.prod(shape)
    if not dist.is_initialized():
        raise ValueError(
            f"mesh {dict(zip(names, shape))} of {n} device(s) needs an "
            "initialized process group (torch.distributed."
            "init_process_group, or torchrun); none is")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} has {n} devices "
                         f"but the process group's world size is {world}")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = MULTI_POD if multi_pod else SINGLE_POD
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_mesh(shape, names, device=device)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, *, device=None):
    """A (data, model) mesh over however many ranks the group has."""
    return init_mesh((n_data, n_model), ("data", "model"), device=device)


def make_sweep_mesh(n_devices: int = 0, *, device=None) -> List:
    """The devices the sweep engine lays its point axis over (JAX's 1-D
    ``("sweep",)`` mesh over the local devices): every visible card for a
    CUDA ``device`` (the default), the CPU alone for ``"cpu"``; with
    ``n_devices`` the first that many. One process drives them all, so no
    process group is needed; ``repro_torch.sweep.engine`` splits a batch
    into one contiguous shard per device."""
    dev = torch.device(_device_type(device))
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(device)]
    if n_devices:
        if n_devices > len(devs):
            raise ValueError(f"a sweep mesh of {n_devices} devices, but "
                             f"{len(devs)} {dev.type} device(s) are visible")
        devs = devs[:n_devices]
    return devs


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that shard the global-batch dimension."""
    from repro_torch.axes import axis_names
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
