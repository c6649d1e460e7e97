#!/usr/bin/env python3
"""Does a torch.profiler trace hold every kernel launch? On the card,
profile the same 20 busy batched cycles (cycles 40..60 of the simulate
cell's scheme_i alpha 0.25 run, B = 1, the window of ``chip_smoke.py``'s
obs (e) check) several times, each from a fresh batch, with telemetry
off and on, and print per window the kernel records, the host's kernel
launch calls, and the launch calls whose kernel record the trace lacks
(matched by correlation id).

    python3 scripts/torch_profile_records.py [--reps 3]

Run from the repository root on a machine with the card; it builds the
port's kernels first.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_records: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build

    build.build_all(sorted(f.stem for f in build.CSRC.glob("*.cu")))
    print(cs.card_line())
    for tele in (False, True):
        for rep in range(args.reps):
            point = cs.seed_points(1)[0].replace(telemetry=tele)
            run = cs._busy_batch(torch, [point])
            cs._busy_window(torch, run, "records", 20)      # cycles 20..40
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            cs._busy_window(torch, run, "records", 20, prof)
            path = ROOT / "build" / f"profile_records_{tele}_{rep}.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
            kernels = [e for e in events if e.get("ph") == "X"
                       and e.get("cat") == "kernel"]
            calls = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") in ("cuda_runtime", "cuda_driver")
                     and "LaunchKernel" in e.get("name", "")]
            have = {e.get("args", {}).get("correlation") for e in kernels}
            lost = sum(e.get("args", {}).get("correlation") not in have
                       for e in calls)
            print(f"telemetry {'on' if tele else 'off'} window {rep}: "
                  f"{len(kernels)} kernel records, {len(calls)} launch "
                  f"calls, {lost} launch calls without a kernel record")
    return 0


if __name__ == "__main__":
    sys.exit(main())
