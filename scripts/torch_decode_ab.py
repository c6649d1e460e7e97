#!/usr/bin/env python3
"""``coded_kv_decode_cuda`` compared between two source trees of the port
on one card, in turns (A, B, B, A).

    python3 scripts/torch_decode_ab.py --trees OLD_TREE NEW_TREE

Each tree is a checkout's root (its ``src/repro_torch``); each turn runs in
a process of its own, which builds that tree's ``coded_kv_decode.cu`` into
the tree's own ``build/`` directory and prints one JSON line: at every
shape of ``chip_smoke.py``'s decode phase, seeded on the card (B = 8,
T = 2,048, NB = 8, P = 64 at the served families' attention widths, the
seeded D = 100 width, ``bench``, ``large`` and ``large_d100``), ~40% of
pages degraded and the phase's mixed lengths (full length for ``bench``
and the two large shapes), the microseconds per launch (L2 flushed before
each launch, CUDA events; the method of the decode phase), the same at no
degraded page and full length, and SDPA (``enable_gqa``) over the logical
cache at full length (timed in every turn: the yardstick, never called by
the port). Each turn also saves its f32 results (q given in f32) under the
tree's ``build/``; the last lines say, per shape, whether the two trees'
f32 results are bit-identical (else their largest difference), each
shape's mean per tree (and the spread) and the card's name and power
limit.

Run from the repository root on a machine with the card.
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
    "yi-6b": ("bfloat16", 8, 2048, 32, 4, 128, 8, 64, False, 100),
    "stablelm-12b": ("bfloat16", 8, 2048, 32, 8, 160, 8, 64, False, 100),
    "granite-20b": ("bfloat16", 8, 2048, 48, 1, 128, 8, 64, False, 100),
    "olmoe-1b-7b": ("bfloat16", 8, 2048, 16, 16, 128, 8, 64, False, 100),
    "phi-3-vision-4.2b": ("bfloat16", 8, 2048, 32, 32, 96, 8, 64, False,
                          100),
    "recurrentgemma-9b": ("bfloat16", 8, 2048, 16, 1, 256, 8, 64, False,
                          100),
    "recurrentgemma-9b_f32": ("float32", 8, 2048, 16, 1, 256, 8, 64, False,
                              100),
    "whisper-tiny": ("bfloat16", 8, 2048, 6, 6, 64, 8, 64, False, 100),
    "odd_width_d100": ("bfloat16", 8, 2048, 8, 2, 100, 8, 64, False, 100),
    "bench": ("float32", 2, 128, 4, 2, 64, 4, 8, True, 100),
    "large": ("bfloat16", 16, 16384, 16, 2, 128, 8, 64, True, 20),
    "large_d100": ("bfloat16", 16, 20480, 16, 2, 100, 8, 64, True, 20),
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


def worker(src: str, turn: int) -> int:
    sys.path.insert(0, src)
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.kernels.coded_kv_decode import ops as ckd_ops

    build.build("coded_kv_decode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2468)
    rng = np.random.default_rng(2468)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out, results = {}, {}
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
        zero = torch.zeros_like(up)
        whole = torch.full_like(seq, t)
        ms = _time_cold(torch, lambda: ckd_kernel.coded_kv_decode_cuda(
            q, *banks, up, seq, dt), reps, flush)
        ms_full = _time_cold(torch, lambda: ckd_kernel.coded_kv_decode_cuda(
            q, *banks, zero, whole, dt), reps, flush)
        qk = q.view(b, h // hkv, hkv, d).transpose(1, 2).reshape(b, h, 1, d)
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        sdpa_ms = _time_cold(torch, lambda: F.scaled_dot_product_attention(
            qk, kt, vt, enable_gqa=True), reps, flush)
        results[name] = ckd_kernel.coded_kv_decode_cuda(
            q.float(), *banks, up, seq, dt).cpu()
        out[name] = dict(us=ms * 1e3, us_full=ms_full * 1e3,
                         sdpa_us=sdpa_ms * 1e3)
        del q, k, v, kt, vt, banks
        torch.cuda.empty_cache()
    path = Path(src).parent / "build" / f"decode_ab_turn{turn}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(results, path)
    print(json.dumps({"src": src, "turn": turn, "results": str(path),
                      "cases": out}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--worker", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--turn", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.turn)
    if not args.trees:
        ap.error("--trees A B is required")
    trees = [str(Path(t).resolve()) for t in args.trees]
    runs = {t: [] for t in trees}
    saved = {t: [] for t in trees}
    for turn, t in enumerate((trees[0], trees[1], trees[1], trees[0])):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(Path(t) / "src"), "--turn", str(turn)],
            cwd=t, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=str(Path(t) / "src")))
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"torch_decode_ab: the turn on {t} failed "
                  f"({proc.returncode})")
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(f"turn {t}: {line}")
        rec = json.loads(line)
        runs[t].append(rec["cases"])
        saved[t].append(rec["results"])
    import torch
    a_out, b_out = (torch.load(saved[t][0]) for t in trees)
    for name in CASES:
        x, y = a_out[name], b_out[name]
        same = torch.equal(x.view(torch.int32), y.view(torch.int32))
        print(f"f32 result {name}: "
              + ("bit-identical" if same else
                 f"differs, max abs {float((x - y).abs().max()):.3g}"))
    for t in trees:
        for name in CASES:
            for key in ("us", "us_full", "sdpa_us"):
                vals = [r[name][key] for r in runs[t]]
                print(f"{t} {name} {key}: {sum(vals) / len(vals):.2f} "
                      f"({min(vals):.2f}-{max(vals):.2f})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(card[0] if card else "nvidia-smi reported no card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
