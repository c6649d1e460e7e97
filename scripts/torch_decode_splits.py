#!/usr/bin/env python3
"""``coded_kv_decode_cuda`` at forced page-range counts, beside the count
``decode_splits`` picks, on one card.

    python3 scripts/torch_decode_splits.py

For each shape (the decode phase's serving widths at B = 8, T = 2,048,
NB = 8, P = 64 with its mixed lengths and ~40% of pages degraded, or at
full length with none; granite-20b's 48 heads on one kv head beside a
16-head group over the same K/V; ``bench``; the two >= 256 MB shapes) it
prints the microseconds per launch (L2 flushed before each launch, CUDA
events; the method of ``chip_smoke.py``'s decode phase) at 1, 2, 4, 8,
11, 16 and 32 ranges and at the picked count (marked ``*``), with the
split kernel, its blocks per SM and head groups. Run from the repository
root on a machine with the card; the last line is the card's name and
power limit.
"""
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

FLUSH_BYTES = 128 << 20          # > the H100's 50 MB L2
# name: (value type, B, T, H, Hkv, D, full length)
CASES = {
    "qwen2.5-3b": ("bfloat16", 8, 2048, 16, 2, 128, False),
    "granite-20b": ("bfloat16", 8, 2048, 48, 1, 128, False),
    "granite-20b_full": ("bfloat16", 8, 2048, 48, 1, 128, True),
    "16_heads_one_group_full": ("bfloat16", 8, 2048, 16, 1, 128, True),
    "recurrentgemma-9b": ("bfloat16", 8, 2048, 16, 1, 256, False),
    "recurrentgemma-9b_full": ("bfloat16", 8, 2048, 16, 1, 256, True),
    "phi-3-vision-4.2b": ("bfloat16", 8, 2048, 32, 32, 96, False),
    "olmoe-1b-7b": ("bfloat16", 8, 2048, 16, 16, 128, False),
    "odd_width_d100": ("bfloat16", 8, 2048, 8, 2, 100, False),
    "large": ("bfloat16", 16, 16384, 16, 2, 128, True),
    "large_d100": ("bfloat16", 16, 20480, 16, 2, 100, True),
    "bench": ("float32", 2, 128, 4, 2, 64, True),
}


def _time_cold(torch, fn, n, flush):
    """Mean µs of ``fn`` with the L2 flushed before each call."""
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
    return sum(a.elapsed_time(b) for a, b in marks) / n * 1e3


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_splits: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.coded_kv_decode import kernel as ckd_kernel
    from repro_torch.kernels.coded_kv_decode import ops as ckd_ops

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2468)
    rng = np.random.default_rng(2468)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    picked = ckd_kernel.decode_splits
    try:
        for name, (vd, b, t, h, hkv, d, full) in CASES.items():
            dt = getattr(torch, vd)
            nb, page = (4, 8) if name == "bench" else (8, 64)

            def normal(*shape):
                return torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dt)

            q = normal(b, h, d)
            banks = ckd_ops.pack_kv_banks(normal(b, t, hkv, d),
                                          normal(b, t, hkv, d), nb, page)[:4]
            n_pages = t // page
            up = torch.from_numpy((rng.random((b, n_pages)) < 0.4)
                                  .astype(np.int32)).to("cuda")
            lens = [t, 0, 37, 1000, 64, 1537, t - 1, 700]
            seq = torch.tensor([t if full else lens[i % 8]
                                for i in range(b)], dtype=torch.int32,
                               device="cuda")
            if full:
                up = torch.zeros_like(up)
            occ = ckd_kernel.decode_occupancy(dt, h, hkv, d, "cuda")
            pick = picked(b, hkv * occ.groups * occ.slices, n_pages, n_sms,
                          occ.blocks)
            row = []
            for ns in sorted({1, 2, 4, 8, 11, 16, 32, pick}
                             & set(range(1, n_pages + 1))):
                ckd_kernel.decode_splits = lambda *a, ns=ns: ns
                us = _time_cold(torch, lambda: ckd_kernel.coded_kv_decode_cuda(
                    q, *banks, up, seq, dt), 10 if name.startswith("large")
                    else 40, flush)
                row.append(f"{ns}:{us:.2f}{'*' if ns == pick else ''}")
            ckd_kernel.decode_splits = picked
            print(f"{name}: {occ.kind}, {occ.blocks} blocks/SM, "
                  f"{occ.groups} head group(s): " + "  ".join(row),
                  flush=True)
            del q, banks
            torch.cuda.empty_cache()
    finally:
        ckd_kernel.decode_splits = picked
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(card[0] if card else "nvidia-smi reported no card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
