#!/usr/bin/env python3
"""The simulator's two XOR kernels and a busy cycle's launches, compared
between two source trees of the port on one card, in turns (A, B, B, A).

    python3 scripts/torch_sim_kernels_ab.py --trees OLD_TREE NEW_TREE

Each tree is a checkout's root (its ``src/repro_torch``); each turn runs in
a process of its own, which builds that tree's kernels into the tree's
own ``build/`` directory and prints one JSON line:

- ``busy``: 20 busy batched cycles of Fig 18's scheme_i alpha 0.25 run
  (8 banks x 320 rows, 8 cores x 96 banded requests, r 0.05, select
  period 32) at seeds 0..B-1, from cycle 40, for B = 1 and 8 (the windows
  of ``chip_smoke.py``'s profiles), through
  ``run_chunk_batch``: wall ms per batched cycle (host clock, no
  profiler), the host's kernel launch calls per batched cycle under
  torch.profiler, and the window's read-branch cycles (its
  ``xor_gather`` launches);
- ``kernels``: microseconds per launch (CUDA events over queued launches)
  of the column entries both trees have, ``gather_decode_cuda`` and
  ``encode_parities_cuda``, at the shapes of ``chip_smoke.py``'s
  simulator kernel phase: gather "bench" (8 x 256 x 256 int32, 64 direct
  reads, with ``index_select`` beside it) and "large" (8 x 8,192 x 1,024
  banks, 12 x 2,048 parities, 16,384 reads of every mode); encode
  "large" (pairwise members) and "large_scheme_i" (scheme_i's 12
  parities), each 8 x 8,192 x 1,024 int32 banks, with its byte bound at
  3.35 TB/s.

Run from the repository root on a machine with the card. The last lines
give each measure's mean per tree and the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
# (B, first cycle): the windows of chip_smoke.py's profiles (its sweep
# phase's at B = 1 and 8, its obs phase's (e) at B = 1)
BUSY_WINDOWS = ((1, 40), (8, 40))
BUSY_CYCLES = 20


def _time_ms(torch, fn, n):
    """Mean ms per call of ``fn`` on the card: CUDA events around ``n``
    calls queued behind a sleep kernel."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _busy(torch, B, start):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.xor_gather import kernel as gk
    from repro_torch.sweep import SweepPoint, build_trace, stack_traces
    from repro_torch.sweep.engine import (mixed_geometry, stack_tunables,
                                          system_for)
    from repro_torch.sweep.grid import batch_geometry_alloc

    pts = [SweepPoint(scheme="scheme_i", alpha=0.25, r=0.05, n_rows=320,
                      n_banks=8, n_cores=8, length=96, select_period=32,
                      trace="banded", seed=s) for s in range(B)]
    sys_ = system_for(pts[0], batch_geometry_alloc(pts), mixed_geometry(pts),
                      device="cuda")
    tr = stack_traces([build_trace(p, device="cuda") for p in pts])
    tn = stack_tunables(pts, sys_.p.queue_depth, "cuda")

    def window(prof=None):
        st = sys_.run_chunk_batch(sys_.init_batch(tn), tr, None, start, tn)
        torch.cuda.synchronize()
        g0 = gk.launches
        t0 = time.perf_counter()
        if prof is None:
            st = sys_.run_chunk_batch(st, tr, None, BUSY_CYCLES, tn)
        else:
            with prof:
                st = sys_.run_chunk_batch(st, tr, None, BUSY_CYCLES, tn)
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / BUSY_CYCLES
        # the window's cycles and read-branch cycles (xor_gather launches)
        return ms, int(st.mem.cycle[0]) - start, gk.launches - g0

    window()                                     # warm
    wall, ran, reads = window()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window(prof)
    path = Path("build") / f"sim_kernels_ab_busy{B}_{start}_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    # the host's launch calls (the kernel records can drop a few)
    launches = sum("LaunchKernel" in e.get("name", "") for e in
                   json.loads(path.read_text())["traceEvents"]
                   if e.get("cat") in ("cuda_runtime", "cuda_driver"))
    return {"B": B, "start": start, "cycles": ran, "wall_ms": wall,
            "launches": launches / BUSY_CYCLES, "read_cycles": reads}


def _kernels(torch):
    from repro_torch.core.codes import get_tables
    from repro_torch.kernels.xor_encode import kernel as ek
    from repro_torch.kernels.xor_gather import kernel as gk

    gen = torch.Generator(device="cuda").manual_seed(4321)
    i32 = torch.int32

    def bits(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             device="cuda", dtype=i32)

    def rint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device="cuda",
                             dtype=i32)

    out = {}
    for shape, (nd, rows, npar, prows, w, n, mix, reps) in {
            "bench": (8, 256, 4, 256, 256, 64, False, 400),
            "large": (8, 8192, 12, 2048, 1024, 16384, True, 40)}.items():
        banks, pars = bits(nd, rows, w), bits(npar, prows, w)
        bank, row = rint(0, nd, n), rint(0, rows, n)
        if mix:
            sib0 = rint(-1, nd, n)
            cols = [bank, row, rint(-1, 7, n), rint(0, npar, n),
                    rint(0, prows, n), sib0,
                    torch.where(sib0 < 0, -1, rint(-1, nd, n))]
        else:
            zero, neg = torch.zeros_like(bank), torch.full_like(bank, -1)
            cols = [bank, row, torch.ones_like(bank), zero, zero, neg, neg]
        res = {"us": _time_ms(torch, lambda: gk.gather_decode_cuda(
            banks, pars, *cols), reps) * 1e3}
        if not mix:
            flat = banks.view(nd * rows, w)
            idx = bank.long() * rows + row.long()
            res["index_select_us"] = _time_ms(torch, lambda: torch.index_select(
                flat, 0, idx), reps) * 1e3
        out[f"xor_gather {shape}"] = res
        del banks, pars
    sch = torch.from_numpy(get_tables("scheme_i").par_members).to("cuda", i32)
    pairs = torch.tensor([[2 * g, 2 * g + 1, -1] for g in range(4)],
                         dtype=i32, device="cuda")
    for shape, members in (("large", pairs), ("large_scheme_i", sch)):
        banks = bits(8, 8192, 1024)
        n_bytes = (8 + members.shape[0]) * 8192 * 1024 * 4 \
            + members.numel() * 4
        us = _time_ms(torch, lambda: ek.encode_parities_cuda(banks, members),
                      20) * 1e3
        out[f"xor_encode {shape}"] = {
            "us": us, "bound_us": n_bytes / HBM_BYTES_PER_S * 1e6}
        del banks
        torch.cuda.empty_cache()
    return out


def worker(src: str) -> int:
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        print("torch_sim_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    build.build_all(["xor_gather", "xor_encode"])
    result = {"src": src, "kernels": _kernels(torch),
              "busy": [_busy(torch, B, c) for B, c in BUSY_WINDOWS]}
    print(json.dumps(result))
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
            [sys.executable, __file__, "--worker", str(Path(t) / "src")],
            cwd=t, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=str(Path(t) / "src")))
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"torch_sim_kernels_ab: the turn on {t} failed "
                  f"({proc.returncode})")
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(f"turn {t}: {line}")
        runs[t].append(json.loads(line))
    for t in trees:
        r = runs[t]
        for k in r[0]["kernels"]:
            vals = {m: [x["kernels"][k][m] for x in r]
                    for m in r[0]["kernels"][k]}
            print(f"{t} {k}: " + ", ".join(
                f"{m} {sum(v) / len(v):.2f} ({min(v):.2f}-{max(v):.2f})"
                for m, v in vals.items()))
        for i, (B, c) in enumerate(BUSY_WINDOWS):
            b = [x["busy"][i] for x in r]
            print(f"{t} busy B={B} cycles {c}..{c + BUSY_CYCLES}: "
                  f"launches/cycle "
                  f"{[x['launches'] for x in b]}, wall ms/cycle "
                  f"{[round(x['wall_ms'], 3) for x in b]}, cycles "
                  f"{[x['cycles'] for x in b]}, read-branch cycles "
                  f"{[x['read_cycles'] for x in b]}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(card[0] if card else "nvidia-smi reported no card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
