"""Fault-tolerant training runtime on one card (``repro.runtime.trainer``
counterpart).

  * **Restore or init** — a run starts from the newest committed
    checkpoint in ``ckpt_dir`` (restored onto the run's device), else from
    a seeded init: f32 master params (``cfg.param_dtype``) drawn on the
    device, zero AdamW moments.
  * **Checkpoint/restart** — asynchronous checkpoints every
    ``ckpt_every`` steps (the newest ``keep`` kept); on an injected fault
    the loop waits for the save in flight, restores the last committed
    step and replays. The data pipeline is a pure function of the step
    index and the prefetcher restarts at the restored step, so with
    ``torch.use_deterministic_algorithms(True)`` (and, on the card,
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before cuBLAS starts) the
    replayed run ends bit-identical to an uninterrupted one.
  * **Straggler detection** — each step's wall time against an EMA
    watermark; a step slower than ``straggler_factor`` x the watermark is
    logged as an event. The first step of a run (which includes
    first-call set-up) never seeds the watermark.
  * **Fault injection** — ``FaultPlan`` raises synthetic failures at
    chosen steps, once each.

Every family trains on tokens alone, as JAX's ``Trainer`` feeds them
(a vision-prefix config without patches); the audio encoder-decoder,
whose forward needs frame embeddings the data pipeline does not make,
raises ``ValueError`` here (JAX's ``Trainer`` fails on it at its first
step). One card and no mesh: a mesh of more than one device raises
``NotImplementedError`` (sharding is ROADMAP.md queue 1 item 5). JAX's
``unroll`` (an XLA scan knob) has no counterpart. ``ckpt_dir=None`` (the
default) checkpoints into a fresh temporary directory, so a run never
resumes another run's steps unless it names their directory.
"""
from __future__ import annotations

import dataclasses
import tempfile
from time import perf_counter
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, Prefetcher, TokenStream
from repro_torch.kernels.common import resolve_device
from repro_torch.models import lm
from repro_torch.optim.adamw import OptConfig, OptState, adamw_init
from repro_torch.runtime import steps as steps_mod


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None   # None: a fresh temporary directory
    keep: int = 3
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 256
    n_micro: int = 1
    q_chunk: int = 0
    remat: bool = True
    straggler_factor: float = 3.0
    ema: float = 0.9


class FaultPlan:
    """Deterministic synthetic failures: raise at the given steps, once
    each."""

    def __init__(self, fail_at: List[int]):
        self.pending = set(fail_at)

    def check(self, step: int):
        if step in self.pending:
            self.pending.discard(step)
            raise RuntimeError(f"injected fault at step {step}")


def check_mesh(mesh: Optional[Tuple[int, ...]]) -> None:
    """The trainer runs on one device: a mesh shape (data, model) of more
    than one device is not ported."""
    n = 1
    for s in mesh or ():
        n *= s
    if n > 1:
        raise NotImplementedError(
            f"mesh {tuple(mesh)}: the port trains on one device; sharding "
            "over a mesh is ROADMAP.md queue 1 item 5 (launch and "
            "sharding)")


class Trainer:
    """``Trainer(cfg, tc, mesh=None, opt_cfg=None, *, device=None)``:
    ``mesh`` is a (data, model) shape, None or all ones; ``device`` the
    card unless named."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 mesh: Optional[Tuple[int, ...]] = None,
                 opt_cfg: Optional[OptConfig] = None, *, device=None):
        lm.check_slice(cfg)
        if cfg.is_encdec:
            raise ValueError(
                f"{cfg.name}: the Trainer feeds tokens only and an "
                "encoder-decoder needs frames (B, F, d_model) in each batch;"
                " train it through make_train_step with frames")
        check_mesh(mesh)
        self.cfg, self.tc = cfg, tc
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or OptConfig(total_steps=tc.steps)
        self.ckpt_dir = tc.ckpt_dir or tempfile.mkdtemp(prefix="ckpt_")
        self.data_cfg = DataConfig(vocab=cfg.vocab, batch=tc.global_batch,
                                   seq_len=tc.seq_len, seed=tc.seed)
        self.stream = TokenStream(self.data_cfg)
        self.prefetcher = Prefetcher(self.stream)
        self.ckpt = CheckpointManager(self.ckpt_dir, keep=tc.keep)
        self.metrics_log: List[Dict[str, float]] = []
        self.events: List[str] = []
        self.train_step = steps_mod.make_train_step(
            cfg, self.opt_cfg, remat=tc.remat, q_chunk=tc.q_chunk,
            n_micro=tc.n_micro)

    # ------------------------------------------------------------------
    def _init_state(self):
        params = lm.init_params(self.cfg, seed=self.tc.seed,
                                device=self.device,
                                dtype=getattr(torch, self.cfg.param_dtype))
        return params, adamw_init(params)

    def _restore_or_init(self):
        step = latest_step(self.ckpt_dir)
        if step is None:
            params, opt = self._init_state()
            return 0, params, opt
        state = restore(self.ckpt_dir, step=step, device=self.device)
        o = state["opt"]
        self.events.append(f"restored step {step}")
        return step, state["params"], OptState(o["step"].cpu(), o["m"],
                                               o["v"])

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Step ``step``'s batch (the prefetcher's) on the device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.prefetcher.get(step).items()}

    # ------------------------------------------------------------------
    def run(self, fault_plan: Optional[FaultPlan] = None,
            max_restarts: int = 3) -> Dict[str, Any]:
        restarts = 0
        try:
            while True:
                try:
                    return self._run_once(fault_plan)
                except RuntimeError as e:
                    if "injected fault" not in str(e) \
                            or restarts >= max_restarts:
                        raise
                    restarts += 1
                    self.events.append(f"recovering ({e})")
                    self.prefetcher.stop()
                    self.ckpt.wait()        # the save in flight commits
        finally:
            self.prefetcher.stop()

    def _run_once(self, fault_plan: Optional[FaultPlan]) -> Dict[str, Any]:
        tc = self.tc
        start, params, opt = self._restore_or_init()
        ema_t: Optional[float] = None
        stragglers = 0
        for step in range(start, tc.steps):
            if fault_plan:
                fault_plan.check(step)
            batch = self.batch(step)
            t0 = perf_counter()
            params, opt, metrics = self.train_step(params, opt, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = perf_counter() - t0
            if ema_t is not None and dt > tc.straggler_factor * ema_t:
                stragglers += 1
                self.events.append(
                    f"straggler step={step} dt={dt:.3f}s ema={ema_t:.3f}s")
            if step != start:               # the first step never seeds it
                ema_t = dt if ema_t is None \
                    else tc.ema * ema_t + (1 - tc.ema) * dt
            metrics.update(step=step, wall_s=dt)
            self.metrics_log.append(metrics)
            if step % tc.log_every == 0:
                print(f"[train] step={step:5d} loss={metrics['loss']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} {dt * 1e3:.0f}ms")
            if tc.ckpt_every and (step + 1) % tc.ckpt_every == 0:
                self.ckpt.save_async(step + 1, {"params": params,
                                                "opt": opt})
        self.ckpt.wait()
        return {
            "params": params, "opt": opt,
            "final_loss": (self.metrics_log[-1]["loss"]
                           if self.metrics_log else None),
            "stragglers": stragglers,
            "events": list(self.events),
        }
