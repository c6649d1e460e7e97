#!/usr/bin/env python3
"""``coded_kv_decode_cuda`` compared between two source trees of the port
on one card, in turns (A, B, B, A).

    python3 scripts/torch_decode_ab.py --trees OLD_TREE NEW_TREE

Each tree is a checkout's root (its ``src/repro_torch``); each turn runs in
a process of its own, which builds that tree's ``coded_kv_decode.cu`` into
the tree's own ``build/`` directory and prints one JSON line: the
microseconds per launch (L2 flushed before each launch, CUDA events; the
method of ``chip_smoke.py``'s decode phase) at shapes both trees take,
seeded on the card: the serving widths of qwen2.5-3b (16/2 x 128),
stablelm-12b (32/8 x 160) and granite-20b (48/1 x 128) at B = 8, T = 2,048,
~40% of pages degraded and the decode phase's mixed lengths, its
``bench`` shape (f32 lanes) and its ``large`` one (B = 16, T = 16,384,
290 MB).

Run from the repository root on a machine with the card. The last lines
give each shape's mean per tree (and the spread) and the card's name and
power limit.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

FLUSH_BYTES = 128 << 20          # > the H100's 50 MB L2
# name: (value type, B, T, H, Hkv, D, NB, P, full length, launches timed)
CASES = {
    "qwen2.5-3b": ("bfloat16", 8, 2048, 16, 2, 128, 8, 64, False, 100),
    "stablelm-12b": ("bfloat16", 8, 2048, 32, 8, 160, 8, 64, False, 100),
    "granite-20b": ("bfloat16", 8, 2048, 48, 1, 128, 8, 64, False, 100),
    "bench": ("float32", 2, 128, 4, 2, 64, 4, 8, True, 100),
    "large": ("bfloat16", 16, 16384, 16, 2, 128, 8, 64, True, 20),
}


def _time_cold(torch, fn, n, flush):
    """Mean ms of ``fn`` with the L2 flushed before each call."""
    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(n):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / n


def worker(src: str) -> int:
    sys.path.insert(0, src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.kernels.coded_kv_decode import ops as ckd_ops

    build.build("coded_kv_decode")
    gen = torch.Generator(device="cuda").manual_seed(2468)
    rng = np.random.default_rng(2468)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = {}
    for name, (vd, b, t, h, hkv, d, nb, page, full, reps) in CASES.items():
        dt = getattr(torch, vd)

        def normal(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dt)

        q, k, v = normal(b, h, d), normal(b, t, hkv, d), normal(b, t, hkv, d)
        banks = ckd_ops.pack_kv_banks(k, v, nb, page)[:4]
        n_pages = t // page
        up = torch.from_numpy((rng.random((b, n_pages)) < 0.4)
                              .astype(np.int32)).to("cuda")
        lens = [t, 0, 37, 1000, 64, 1537, t - 1, 700]
        seq = torch.tensor([t if full else lens[i % 8] for i in range(b)],
                           dtype=torch.int32, device="cuda")
        ms = _time_cold(torch, lambda: ckd_kernel.coded_kv_decode_cuda(
            q, *banks, up, seq, dt), reps, flush)
        out[name] = ms * 1e3
        del q, k, v, banks
        torch.cuda.empty_cache()
    print(json.dumps({"src": src, "us": out}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--worker", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker)
    if not args.trees:
        ap.error("--trees A B is required")
    trees = [str(Path(t).resolve()) for t in args.trees]
    runs = {t: [] for t in trees}
    for t in (trees[0], trees[1], trees[1], trees[0]):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(Path(t) / "src")],
            cwd=t, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=str(Path(t) / "src")))
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"torch_decode_ab: the turn on {t} failed "
                  f"({proc.returncode})")
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(f"turn {t}: {line}")
        runs[t].append(json.loads(line)["us"])
    for t in trees:
        for name in CASES:
            vals = [r[name] for r in runs[t]]
            print(f"{t} {name}: {sum(vals) / len(vals):.2f} us/launch "
                  f"({min(vals):.2f}-{max(vals):.2f})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(card[0] if card else "nvidia-smi reported no card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
