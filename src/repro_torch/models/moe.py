"""Mixture-of-Experts block (``repro.models.moe`` counterpart): a top-k
router and capacity-based dispatch, GShard style. Tokens are routed in
groups of ``cfg.moe_group``; in a group every expert takes at most ``cap``
(token, choice) assignments, token-major (token 0's k choices first, then
token 1's), and an assignment past its expert's capacity is dropped: it
adds nothing and the kept gates are not renormalised.

JAX builds dense one-hot dispatch and combine matrices; the port computes
the same function with gathers over fixed shapes: each kept assignment's
token is gathered into an ``(ng, e, cap, d)`` buffer (empty slots read a
zero row), the experts run as one batched product per weight, and each
token gathers its kept slots back and sums them with its gates in f32,
cast once. Nothing reads a value back to the host, so a decode step makes
no sync here. Every op is out of place, so autograd can differentiate the
block.

Free decode slots and the left padding of a prompt are routed like any
token and take capacity, as in the JAX package: masking them out would
change what the real tokens get.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.axes import (fsdp_gather, from_local, is_dtensor,
                             redistribute, shard)
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ly

Params = Dict[str, torch.Tensor]


class Routing(NamedTuple):
    """One dispatch's routing, each field (ng, g, k): the experts chosen,
    best first (on a tie the lower index first, as ``jax.lax.top_k``);
    their gates (f32 softmax over the k chosen logits); each assignment's
    slot (its rank among the group's earlier assignments to that expert);
    and whether it is kept (slot < capacity)."""
    idx: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


def moe_init(cfg: ModelConfig, gen: torch.Generator, dtype,
             lead=()) -> Params:
    """JAX's leaves: ``router`` (d, e), ``w_up`` (e, d, f), ``w_down``
    (e, f, d), ``w_gate`` (e, d, f) when gated; ``lead`` prefixes every
    shape (a layer axis), drawn one layer's leaf at a time."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": ly.normal_init(gen, (d, e), d ** -0.5, dtype, lead),
         "w_up": ly.normal_init(gen, (e, d, f), d ** -0.5, dtype, lead),
         "w_down": ly.normal_init(gen, (e, f, d), f ** -0.5, dtype, lead)}
    if cfg.mlp_gated:
        p["w_gate"] = ly.normal_init(gen, (e, d, f), d ** -0.5, dtype, lead)
    return p


def groups(cfg: ModelConfig, n: int) -> Tuple[int, int, int]:
    """(tokens a group g, groups ng, capacity per expert) for ``n`` tokens:
    g = min(moe_group, n), cap = max(1, int(g * k * capacity_factor / e))
    in Python floats, as JAX computes it on the host."""
    g = min(cfg.moe_group, n)
    if n % g:
        raise ValueError(f"{cfg.name}: {n} tokens are not a multiple of the "
                         f"MoE group of {g}")
    cap = max(1, int(g * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return g, n // g, cap


def router_logits(cfg: ModelConfig, p: Params, x: torch.Tensor
                  ) -> torch.Tensor:
    """x (B, T, D) -> f32 logits (ng, g, e): the matmul in x's dtype, then
    the cast, as JAX does."""
    b, t, d = x.shape
    g, ng, _ = groups(cfg, b * t)
    return (x.reshape(ng, g, d) @ p["router"]).float()


def route(cfg: ModelConfig, logits: torch.Tensor, cap: int) -> Routing:
    """Top-k of each token's f32 logits (ng, g, e) by a stable descending
    sort (``torch.topk`` promises no order among ties; the CPU and the
    card could disagree), the softmax gates, and each assignment's
    capacity slot in token-major order."""
    k = cfg.top_k
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    ng, g = idx.shape[:2]
    flat = idx.reshape(ng, g * k)
    onehot = F.one_hot(flat, cfg.n_experts)
    earlier = onehot.cumsum(1) - onehot
    pos = earlier.gather(-1, flat[..., None]).reshape(ng, g, k)
    return Routing(idx, torch.softmax(top, dim=-1), pos, pos < cap)


def experts(cfg: ModelConfig, p: Params, x: torch.Tensor, r: Routing,
            cap: int) -> torch.Tensor:
    """The routed tokens through their experts and back: x (B, T, D) and
    its routing -> (B, T, D) in x's dtype."""
    b, t, d = x.shape
    ng, g = r.idx.shape[:2]
    xin, slot, keep = _dispatch(cfg, x.reshape(ng, g, d), r, cap)
    out = _expert_ffn(cfg, p, xin)
    return _combine(cfg, out, r, slot, keep, x.dtype).reshape(b, t, d)


def _dispatch(cfg, xg, r: Routing, cap: int):
    """Each kept assignment's token of the groups xg (ng, g, d) gathered
    into (ng, e, cap, d) expert slots (an empty slot reads a zero row);
    with each assignment's slot and whether it is kept."""
    ng, g, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    keep = r.keep.reshape(ng, g * k)
    a = torch.arange(g * k, device=xg.device).expand(ng, -1)
    # a kept assignment's slot e * cap + pos is its own; a dropped one
    # goes to a sink of its own past the slots, so every index is unique
    slot = torch.where(keep, r.idx.reshape(ng, g * k) * cap
                       + r.pos.reshape(ng, g * k), e * cap + a)
    owner = torch.full((ng, e * cap + g * k), g * k, dtype=torch.long,
                       device=xg.device).scatter(1, slot, a)
    tok = owner[:, :e * cap] // k                # g: an empty slot
    xpad = torch.cat([xg, xg.new_zeros(ng, 1, d)], 1)
    xin = xpad.gather(1, tok[..., None].expand(-1, -1, d)) \
        .reshape(ng, e, cap, d)
    return xin, slot, keep


def _expert_ffn(cfg, p, xin):
    """The expert MLPs over their slots: (ng, e, cap, d) -> (ng, e, cap,
    d), one batched product per weight."""
    w = {k: fsdp_gather(v) for k, v in p.items() if k != "router"}
    up = torch.einsum("necd,edf->necf", xin, w["w_up"])
    if cfg.mlp_gated:
        h = ly._act(cfg, torch.einsum("necd,edf->necf", xin, w["w_gate"])) \
            * up
    else:
        h = ly._act(cfg, up)
    return torch.einsum("necf,efd->necd", h, w["w_down"])


def _combine(cfg, out, r: Routing, slot, keep, dtype):
    """Each token's kept slots of the expert outputs (ng, e, cap, d)
    summed with its gates in f32, cast once -> (ng, g, d)."""
    ng, e, cap, d = out.shape
    g, k = r.idx.shape[1:]
    out = torch.cat([out.reshape(ng, e * cap, d), out.new_zeros(ng, 1, d)],
                    1)
    sel = torch.where(keep, slot, e * cap)       # dropped: the zero row
    picked = out.gather(1, sel[..., None].expand(-1, -1, d)) \
        .reshape(ng, g, k, d)
    # JAX casts the gates to the compute dtype before the combine
    w = r.gates.to(dtype).float()
    return (picked.float() * w[..., None]).sum(2).to(dtype)


def _moe_sharded(cfg: ModelConfig, p: Params, x, cap: int):
    """``moe_block`` on DTensors. The tokens are pinned to the batch's
    placements and the routing, the dispatch gather and the combine run
    on each rank's own groups (every op there is per group; the model
    ranks repeat them), with the router's weight gathered. Only the
    expert products run as DTensors, on the expert weights' placements;
    under ``cfg.moe_ep`` the slots are pinned with their expert axis on
    ``model`` (JAX's pins; the port keeps the group axis on the batch
    axes, where JAX's pin replicates it), then gathered back to the
    groups' placements for the combine. Where a group spans the batch
    shards (a decode step's B tokens in one group) the tokens are
    gathered first and every rank routes every group."""
    from torch.distributed.tensor import Partial, Replicate
    b, t, d = x.shape
    g, ng, _ = groups(cfg, b * t)
    x = shard(x, "batch", None, None)
    mesh, bpl = x.device_mesh, tuple(x.placements)
    spans = (x.to_local().shape[0] * t) % g != 0
    if spans:
        bpl = (Replicate(),) * mesh.ndim
        x = redistribute(x, bpl)
    xl = x.to_local(grad_placements=bpl)
    xg = xl.reshape(-1, g, d)
    router = p["router"]
    if is_dtensor(router):
        gpl = [Partial() if pl != Replicate() else Replicate() for pl in bpl]
        router = redistribute(router, (Replicate(),) * mesh.ndim).to_local(
            grad_placements=gpl)
    r = route(cfg, (xg @ router).float(), cap)
    xin, slot, keep = _dispatch(cfg, xg, r, cap)
    xin = from_local(xin, mesh, bpl, (ng,) + tuple(xin.shape[1:]))
    if cfg.moe_ep:
        xin = shard(xin, "batch", "experts", None, None)
    out = _expert_ffn(cfg, p, xin)
    if cfg.moe_ep:
        out = shard(out, "batch", "experts", None, None)
    out = shard(out, "batch", None, None, None)
    y = _combine(cfg, out.to_local(grad_placements=bpl), r, slot, keep,
                 x.dtype)
    y = from_local(y.reshape(xl.shape), mesh, bpl, (b, t, d))
    return shard(y, "batch", None, None) if spans else y


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D): JAX's ``moe_block``."""
    _, _, cap = groups(cfg, x.shape[0] * x.shape[1])
    if is_dtensor(x):
        return _moe_sharded(cfg, p, x, cap)
    return experts(cfg, p, x, route(cfg, router_logits(cfg, p, x), cap), cap)
