"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule (``repro.optim.adamw`` counterpart). Moments are f32 whatever
the params' dtype.

The update runs IN PLACE: ``adamw_update`` scales the gradients, writes
the new moments into ``state.m``/``state.v`` and the new params into
``params``, using each gradient's buffer as its scratch. JAX's functional
update would allocate new params, moments and temporaries of every leaf,
which a full-width model on one card has no room for. The arithmetic is
JAX's; only the rounding of ``p - lr * (m_hat / denom + wd * p)``, done as
``p * (1 - lr * wd) + (-lr / b1c) * m / denom``, differs in the last bits.

Trees are nested dicts of tensors (the model's params); leaves are
visited in JAX's order (dict keys sorted), so sums over leaves add in the
same order as JAX's.

Under a mesh the leaves are DTensors, the gradients already at their
params' placements (``runtime.steps``): each leaf's norm is reduced to
its full value (the same on every rank) before the global norm, and the
update runs in place on the local shards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Tuple

import torch

from repro_torch.axes import is_dtensor


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # () int32, on the CPU: the schedule is host math
    m: Any              # f32 tree like params
    v: Any              # f32 tree like params


def tree_leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                          ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of every leaf, dict keys sorted as JAX sorts
    them."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_leaves_with_path(tree[k], path + (k,))]
    return [(path, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_unflatten(like: Any, leaves: list) -> Any:
    """``leaves`` (in ``tree_leaves`` order) in the structure of
    ``like``."""
    return _rebuild(like, iter(leaves))


def _rebuild(like: Any, it) -> Any:
    if isinstance(like, dict):
        vals = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: vals[k] for k in like}
    return next(it)


def cosine_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor): linear
    warmup, then a cosine down to ``min_lr_frac``; a 0-d f32 CPU tensor
    computed in f32, as JAX does."""
    s = torch.as_tensor(step).to("cpu", torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = ((s - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-d tensor on
    the leaves' device)."""
    leaves = [leaf.float() for leaf in tree_leaves(tree)]
    norms = [n.full_tensor() if is_dtensor(n) else n
             for n in torch._foreach_norm(leaves)]
    return torch.stack(norms).square().sum().sqrt()


def adamw_init(params: Any) -> OptState:
    """Zero f32 moments like ``params`` (DTensors at their placements),
    step 0."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32) \
        if is_dtensor(p) else torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def _decay_mask(name: str) -> bool:
    """No weight decay on norms, biases and scalars: JAX's test on the
    leaf's last key."""
    return not any(s in name for s in ("scale", "bias", "A_log", "D",
                                       "dt_bias", "norm"))


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Any, state: OptState, params: Any
                 ) -> Tuple[Any, OptState, torch.Tensor]:
    """One AdamW step IN PLACE: returns (``params``, the state with its
    step advanced and ``m``/``v`` updated, the gradients' global norm
    before clipping). ``grads`` are consumed (scaled, then used as
    scratch). Clips by global norm."""
    gnorm = global_norm(grads)
    scale = (cfg.clip_norm / gnorm.clamp(min=1e-9)).clamp(max=1.0)
    step = state.step + 1
    lr = float(cosine_schedule(cfg, step))
    sf = step.to(torch.float32)
    b1c = float(1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), sf))
    b2c = float(1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), sf))
    leaves = zip(tree_leaves_with_path(params), tree_leaves(grads),
                 tree_leaves(state.m), tree_leaves(state.v))
    for (path, p), g, m, v in leaves:
        if is_dtensor(p):                  # the local shards, in place
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        g = g.float()                      # no copy for f32 grads
        g.mul_(scale)
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        denom = torch.div(v, b2c, out=g).sqrt_().add_(cfg.eps)
        pf = p if p.dtype == torch.float32 else p.float()
        if _decay_mask(path[-1] if path else ""):
            pf.mul_(1 - lr * cfg.weight_decay)
        pf.addcdiv_(m, denom, value=-lr / b1c)
        if pf is not p:
            p.copy_(pf)
    return params, OptState(step, state.m, state.v), gnorm
