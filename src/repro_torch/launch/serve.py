"""Serving launcher: continuous batching over synthetic requests, on the
CUDA card unless ``--device`` names another.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      [--reduced] [--device cpu] --requests 8 --slots 4 [--telemetry] \
      [--kv-banks 0]

``--arch`` is one of the configs the port serves: the dense qwen2.5-3b,
yi-6b, stablelm-12b and granite-20b, the MoE olmoe-1b-7b (on the pool)
and mixtral-8x7b (sliding window: the ring; it needs more than one card
at full width, so serve it ``--reduced``), the vision-prefix
phi-3-vision-4.2b (the ring; zero patch embeddings over each prompt's
first ``n_patches`` positions, so ``--max-prompt`` must reach 576 at full
width, 8 reduced), the SSM mamba2-2.7b (the ring holds its conv tails and
f32 states; a prompt past 128 positions must be a multiple of the
128-position SSD chunk, so ``--max-prompt`` 64 or 512, say), the
hybrid recurrentgemma-9b (RG-LRU states and a local-attention ring, whose
window must fit the prompt: ``--max-prompt`` >= 2048 at full width, 16
reduced) and the audio encoder-decoder whisper-tiny (the ring; each
prompt's prefill encodes zero frame embeddings of 1,500 frames, 32
reduced, and the ring holds their cross-attention K/V per slot).

Reports steady-state decode throughput (a warm-up request runs first, so
the timed run excludes first-call set-up and the kernel build),
per-request TTFT/ITL from the host-side lifecycle log and, with
``--telemetry``, the device serve planes' summary (read provenance, port
cycles saved, recode backlog) of the coded KV pool. ``--kv-banks 0``
serves from the ring cache instead of the pool.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels.common import resolve_device
from repro_torch.models import lm
from repro_torch.obs import serve as obs_serve
from repro_torch.runtime.server import Request, ServeConfig, Server


def _mk_requests(cfg, n, base=0):
    return [Request(rid=base + i,
                    prompt=[(7 * (base + i) + j) % max(cfg.vocab // 2, 2) + 1
                            for j in range(5 + i % 7)])
            for i in range(n)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--uncoded", action="store_true",
                    help="uncoded KV pool (no parity arrays)")
    ap.add_argument("--page", type=int, default=0,
                    help="pool page size in tokens (0: config default)")
    ap.add_argument("--recode-budget", type=int, default=None,
                    help="parity rows recoded per step (default: all)")
    ap.add_argument("--telemetry", action="store_true",
                    help="device serve metric planes + summary")
    ap.add_argument("--kv-banks", type=int, default=None,
                    help="KV banks (default: the config's; 0: ring cache)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kv_banks is not None:
        cfg = dataclasses.replace(cfg, kv_banks=args.kv_banks)
    if cfg.frontend == "vision_stub" and args.max_prompt < cfg.n_patches:
        ap.error(f"{cfg.name} writes {cfg.n_patches} patch embeddings over "
                 f"each prompt: pass --max-prompt >= {cfg.n_patches} (and "
                 "--max-seq above it)")
    for w in (cfg.sliding_window, cfg.local_window):
        if w > args.max_prompt:
            ap.error(f"{cfg.name} attends over a window of {w}: pass "
                     f"--max-prompt >= {w} (and --max-seq above it)")
    params = lm.init_params(cfg, seed=args.seed, device=device)
    sc = ServeConfig(n_slots=args.slots, max_prompt=args.max_prompt,
                     max_seq=args.max_seq, max_new_tokens=args.max_new,
                     coded=not args.uncoded, telemetry=args.telemetry,
                     page=args.page, recode_budget=args.recode_budget)
    srv = Server(cfg, sc, params, device=device)
    del params

    for r in _mk_requests(cfg, 1, base=10_000):
        srv.submit(r)
    srv.run_until_drained()
    warm_steps = srv.steps_run

    reqs = _mk_requests(cfg, args.requests)
    _sync(device)
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    _sync(device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in reqs)
    for r in reqs[:4]:
        print(f"req {r.rid}: {r.out}")
    pool = ("coded pool" if sc.coded else "uncoded pool") \
        if srv.pooled else "ring cache"
    rate = f"{n_tok / dt:.1f} tok/s" if dt > 0 else "n/a tok/s"
    print(f"served {len(reqs)} requests / {n_tok} tokens in {dt:.2f}s "
          f"({rate} steady-state, {srv.steps_run - warm_steps} decode "
          f"steps, {pool}, {device})")
    for s in srv.log.spans():
        if s["rid"] >= 10_000:
            continue
        itl = s["inter_token_s"]
        mean_itl = 1e3 * sum(itl) / len(itl) if itl else 0.0
        print(f"  req {s['rid']}: wait {1e3 * s['admission_wait_s']:.1f} ms"
              f" ttft {1e3 * s['ttft_s']:.1f} ms"
              f" mean-itl {mean_itl:.1f} ms ({s['n_tokens']} tokens)")
    snap = srv.serve_snapshot()
    if snap is not None:
        print(obs_serve.format_summary(snap))


if __name__ == "__main__":
    main()
