"""Training launcher, on the CUDA card unless ``--device`` names another.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --steps 200 --batch 8 --seq 256 [--reduced] [--device cpu] \
      [--ckpt DIR] [--fail-at 7]

``--arch`` is any config but the audio one: the dense qwen2.5-3b, yi-6b,
stablelm-12b, granite-20b, the MoE olmoe-1b-7b and mixtral-8x7b, the
vision-prefix phi-3-vision-4.2b (on tokens alone, as JAX's ``Trainer``
feeds it), the SSM mamba2-2.7b (``--seq`` past 128 a multiple of 128,
the SSD chunk) and the hybrid recurrentgemma-9b. whisper-tiny raises
``ValueError``: its batches need frame embeddings, which the data
pipeline does not make (train it through ``make_train_step``).
``--reduced`` trains the CPU-sized variant. Without ``--ckpt`` the run
checkpoints into a fresh temporary directory; with it, the run resumes
from the newest step committed there. Deterministic algorithms are on
(``CUBLAS_WORKSPACE_CONFIG=:4096:8`` is set before cuBLAS starts), so a
run restarted by ``--fail-at`` ends bit-identical to an uninterrupted
one.

``--mesh-data``/``--mesh-model`` above 1 shard the run over a (data,
model) ``DeviceMesh``, one process per device under ``torchrun`` (it
reads ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``): each rank trains on
``cuda:{LOCAL_RANK}`` with NCCL, or on the CPU with gloo under
``--device cpu``; rank 0 alone prints. Without ``torchrun``, or with a
world size other than the mesh's, the run raises ``ValueError``::

  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch qwen2.5-3b --reduced \
      --device cpu --mesh-data 2 --mesh-model 2 --steps 3
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs.base import get_config
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.trainer import FaultPlan, TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory to resume from and write to "
                    "(default: a fresh temporary one)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject synthetic faults at these steps "
                    "(recovery demo)")
    args = ap.parse_args(argv)

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _train(args)
    finally:
        torch.use_deterministic_algorithms(was)


def _init_group(args) -> bool:
    """The process group of a ``torchrun`` launch, for a mesh of more
    than one device (NCCL on the card, gloo on the CPU); False when the
    run is plain. A mesh without ``torchrun``'s environment is left to
    raise in ``launch.mesh``."""
    if args.mesh_data * args.mesh_model == 1 or "RANK" not in os.environ:
        return False
    import torch.distributed as dist
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if cpu else "nccl")
    return True


def _train(args):
    group = _init_group(args)
    try:
        return _run(args)
    finally:
        if group:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt, global_batch=args.batch,
                     seq_len=args.seq, n_micro=args.n_micro)
    opt = OptConfig(lr=args.lr, total_steps=args.steps,
                    warmup_steps=max(args.steps // 20, 5))
    tr = Trainer(cfg, tc, (args.mesh_data, args.mesh_model), opt,
                 device=args.device)
    plan = FaultPlan(args.fail_at) if args.fail_at else None
    out = tr.run(fault_plan=plan)
    if tr.rank0:
        print(f"done: final_loss={out['final_loss']:.4f} "
              f"stragglers={out['stragglers']} events={out['events']} "
              f"ckpt={tr.ckpt_dir} ({tr.device})")
    return out


if __name__ == "__main__":
    main()
