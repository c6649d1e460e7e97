"""Carry params and simulator states between the JAX package and the port.

``params_from_jax(cfg, tree, device)`` takes the JAX param tree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's tree:
the same nesting, the same ``(d_in, d_out)`` layout (the port computes
``x @ W`` as JAX does, so nothing is transposed), the same dtypes.

``opt_state_from_jax(cfg, opt, device)`` takes the JAX ``OptState``
with numpy leaves and returns the port's (moments on ``device``, the step
on the CPU); ``params_to_numpy`` and ``opt_state_to_numpy`` go back (the
JAX trees' leaves, in the port's types), so both packages can start a
training step from the same state.

``sim_state_from_numpy(host, device)`` takes a JAX ``SimState`` with numpy
leaves (``jax.device_get(st)``) and returns the port's ``SimState``;
``sim_state_to_numpy(st)`` goes back. The field order is the same on both
sides; the wide (lo, hi) uint32 counter pairs of JAX are int64 in the port,
and so are the fault leaf's uint32 ``dead_cycles`` and the telemetry
planes' uint32 counters (``obs.planes.COUNTER_FIELDS``; the high-water
marks and the queue slots' core ids are int32 on both sides). Both take
one point's state or a batch's (a leading point axis on every leaf), with
or without the fault and telemetry leaves.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.state import WIDE_FIELDS, MemState
from repro_torch.core.system import SimState
from repro_torch.faults.plan import FaultState
from repro_torch.models import lm
from repro_torch.obs.planes import COUNTER_FIELDS, Telemetry
from repro_torch.optim.adamw import OptState


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                    # a writable, contiguous copy
    if a.dtype.name == "bfloat16":     # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any],
                    device) -> Dict[str, Any]:
    """The JAX tree (numpy leaves) as the port's params on ``device``."""
    lm.check_slice(cfg)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(np.asarray(node), device)

    return conv(tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params (training's f32 master params, say) as numpy
    leaves, copies."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return node.detach().cpu().numpy().copy()

    return conv(params)


def opt_state_from_jax(cfg: ModelConfig, opt, device) -> OptState:
    """A JAX ``OptState`` (numpy leaves) as the port's: the f32 moments on
    ``device``, the int32 step on the CPU."""
    return OptState(torch.from_numpy(np.array(opt.step, np.int32)),
                    params_from_jax(cfg, opt.m, device),
                    params_from_jax(cfg, opt.v, device))


def opt_state_to_numpy(opt: OptState) -> OptState:
    """The port's ``OptState`` with numpy leaves in JAX's layout (build
    ``repro.optim.adamw.OptState(*opt_state_to_numpy(st))`` from it)."""
    return OptState(np.array(int(opt.step), np.int32),
                    params_to_numpy(opt.m), params_to_numpy(opt.v))


def sim_state_from_numpy(host, device) -> SimState:
    """A JAX ``SimState`` with numpy leaves as the port's state on
    ``device``."""
    m = host.mem
    leaves = {}
    for name in MemState._fields:
        a = getattr(m, name)
        if name == "tele":
            if a is not None:
                leaves[name] = Telemetry(*(
                    _tensor(np.asarray(x, np.int64) if f in COUNTER_FIELDS
                            else x, device)
                    for f, x in zip(Telemetry._fields, a)))
            continue
        if name == "fault":
            if a is not None:
                leaves[name] = FaultState(*(
                    _tensor(np.asarray(x, np.int64) if f == "dead_cycles"
                            else x, device)
                    for f, x in zip(FaultState._fields, a)))
            continue
        a = np.asarray(a)
        if name in WIDE_FIELDS:
            w = a.astype(np.int64)
            a = w[..., 0] + (w[..., 1] << 32)
        leaves[name] = torch.from_numpy(np.array(a)).to(device)
    return SimState(MemState(**leaves), _tensor(host.core_ptr, device),
                    _tensor(host.done_cycle, device))


def sim_state_to_numpy(st: SimState) -> SimState:
    """The port's state with numpy leaves in JAX's layout: int64 counters
    back to (lo, hi) uint32 pairs, everything else its own dtype."""
    leaves = {}
    for name in MemState._fields:
        a = getattr(st.mem, name)
        if a is None:
            continue
        if name == "fault":
            leaves[name] = FaultState(*(
                x.cpu().numpy().astype(np.uint32) if f == "dead_cycles"
                else x.cpu().numpy() for f, x in zip(FaultState._fields, a)))
            continue
        if name == "tele":
            leaves[name] = Telemetry(*(
                x.cpu().numpy().astype(np.uint32) if f in COUNTER_FIELDS
                else x.cpu().numpy() for f, x in zip(Telemetry._fields, a)))
            continue
        a = a.cpu().numpy()
        if name in WIDE_FIELDS:
            a = np.stack([a & 0xFFFFFFFF, a >> 32], -1).astype(np.uint32)
        leaves[name] = a
    return SimState(MemState(**leaves), st.core_ptr.cpu().numpy(),
                    st.done_cycle.cpu().numpy())
