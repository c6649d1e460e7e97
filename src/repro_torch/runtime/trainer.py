"""Fault-tolerant training runtime (``repro.runtime.trainer``
counterpart), on one card or sharded over a ``DeviceMesh``.

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
  * **Sharding** — ``mesh`` is a (data, model) shape or a ``DeviceMesh``.
    A shape of one device keeps the plain path (no process group, no
    DTensor); a larger shape is made a mesh over the initialized process
    group (``launch.mesh``: a missing group or a world size that differs
    raises ``ValueError``, never a quiet single-device run); a
    ``DeviceMesh``, one of size 1 included, takes the DTensor path.
    There params and moments are DTensors at JAX's placements
    (``launch.sharding.param_shardings``/``opt_shardings``), each batch
    is sharded by ``data_shardings``, and every rank runs the same loop.
    A checkpoint holds full leaves (rank 0 writes), and
    ``_restore_or_init`` distributes them to the current mesh's
    placements: a run resumes on another mesh, or on one device, from
    any checkpoint (the elastic re-mesh).

Every family trains on tokens alone, as JAX's ``Trainer`` feeds them
(a vision-prefix config without patches); the audio encoder-decoder,
whose forward needs frame embeddings the data pipeline does not make,
raises ``ValueError`` here (JAX's ``Trainer`` fails on it at its first
step). JAX's ``unroll`` (an XLA scan knob) has no counterpart. ``ckpt_dir=None`` (the
default) checkpoints into a fresh temporary directory, so a run never
resumes another run's steps unless it names their directory.
"""
from __future__ import annotations

import dataclasses
import tempfile
from time import perf_counter
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, Prefetcher, TokenStream
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_debug_mesh
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


def _as_mesh(mesh, device):
    """None for the plain path (no mesh, or a shape of one device); a
    ``DeviceMesh`` as it is; a larger (data, model) shape as a mesh over
    the process group, which must exist with that world size."""
    if mesh is None or hasattr(mesh, "device_type"):
        return mesh
    shape = tuple(mesh)
    n = 1
    for s in shape:
        n *= s
    if n == 1:
        return None
    if len(shape) != 2:
        raise ValueError(f"mesh {shape}: a (data, model) shape")
    return make_debug_mesh(*shape, device=device)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _shared_tmpdir(mesh) -> str:
    """A fresh temporary checkpoint directory; under a mesh rank 0 makes
    it and every rank gets its name."""
    if mesh is None:
        return tempfile.mkdtemp(prefix="ckpt_")
    import torch.distributed as dist
    name = [tempfile.mkdtemp(prefix="ckpt_")
            if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(name, src=0)
    return name[0]


class FaultPlan:
    """Deterministic synthetic failures: raise at the given steps, once
    each."""

    def __init__(self, fail_at: List[int]):
        self.pending = set(fail_at)

    def check(self, step: int):
        if step in self.pending:
            self.pending.discard(step)
            raise RuntimeError(f"injected fault at step {step}")


class Trainer:
    """``Trainer(cfg, tc, mesh=None, opt_cfg=None, *, device=None)``:
    ``mesh`` is a (data, model) shape, None, or a ``DeviceMesh``;
    ``device`` the card unless named (a mesh's device type is the
    mesh's: ``cuda`` the current card, or ``cpu``)."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 mesh: Union[None, Tuple[int, ...], Any] = None,
                 opt_cfg: Optional[OptConfig] = None, *, device=None):
        lm.check_slice(cfg)
        if cfg.is_encdec:
            raise ValueError(
                f"{cfg.name}: the Trainer feeds tokens only and an "
                "encoder-decoder needs frames (B, F, d_model) in each batch;"
                " train it through make_train_step with frames")
        self.cfg, self.tc = cfg, tc
        self.mesh = _as_mesh(mesh, device)
        if self.mesh is None:
            self.device = resolve_device(device)
        elif self.mesh.device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(self.mesh.device_type)
        self.rank0 = self.mesh is None or _rank() == 0
        self.opt_cfg = opt_cfg or OptConfig(total_steps=tc.steps)
        self.ckpt_dir = tc.ckpt_dir or _shared_tmpdir(self.mesh)
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

    def _shardings(self):
        """The state's shardings on the trainer's mesh, in a restored
        checkpoint's nesting (the step count stays on the host)."""
        p_sh = shd.param_shardings(self.cfg, lm.abstract_params(self.cfg),
                                   self.mesh)
        return {"params": p_sh, "opt": {"step": None, "m": p_sh, "v": p_sh}}

    def _wait(self):
        """Join the save in flight; under a mesh every rank waits for
        rank 0's commit before it reads the directory."""
        self.ckpt.wait()
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier()

    # ------------------------------------------------------------------
    def _init_state(self):
        params = lm.init_params(self.cfg, seed=self.tc.seed,
                                device=self.device,
                                dtype=getattr(torch, self.cfg.param_dtype))
        if self.mesh is not None:       # every rank drew the same params
            params = shd.distribute(params, self._shardings()["params"])
        return params, adamw_init(params)

    def _restore_or_init(self):
        step = latest_step(self.ckpt_dir)
        if step is None:
            params, opt = self._init_state()
            return 0, params, opt
        state = restore(self.ckpt_dir, step=step, device=self.device,
                        shardings=None if self.mesh is None
                        else self._shardings())
        o = state["opt"]
        self.events.append(f"restored step {step}")
        return step, state["params"], OptState(o["step"].cpu(), o["m"],
                                               o["v"])

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Step ``step``'s batch (the prefetcher's) on the device; under a
        mesh, sharded over its batch axes (``data_shardings``)."""
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.prefetcher.get(step).items()}
        if self.mesh is None:
            return batch
        return shd.distribute(batch, shd.data_shardings(self.mesh, batch))

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
                    self._wait()            # the save in flight commits
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
            if step % tc.log_every == 0 and self.rank0:
                print(f"[train] step={step:5d} loss={metrics['loss']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} {dt * 1e3:.0f}ms")
            if tc.ckpt_every and (step + 1) % tc.ckpt_every == 0:
                self.ckpt.save_async(step + 1, {"params": params,
                                                "opt": opt})
        self._wait()
        return {
            "params": params, "opt": opt,
            "final_loss": (self.metrics_log[-1]["loss"]
                           if self.metrics_log else None),
            "stragglers": stragglers,
            "events": list(self.events),
        }
