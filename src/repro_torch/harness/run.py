"""Run every paper harness of the port: the counterpart of
``benchmarks/run.py`` for what the port has.

    python -m repro_torch.harness.run --fast                # on the card
    python -m repro_torch.harness.run --fast --device cpu

It runs ``tab_schemes``, ``fig18_dedup``, ``fig19_split``, ``fig20_ramp``
(length 48 with ``--fast``, else 96), ``fig_faults`` (``--smoke`` with
``--fast``) and the quickstart, then names what the JAX runner also runs
that the port does not have yet. A harness that fails (the availability
gate included) stops the run with its error.
"""
from __future__ import annotations

import argparse
import time

# What benchmarks/run.py runs that the port has not, and why.
NOT_PORTED = {
    "bench_sweep, bench_cycles, bench_stream, bench_kvbank, bench_kernels, "
    "bench_serve, bench_embedding":
        "the port-side benchmarks are not written yet (ROADMAP queue 1 "
        "item 3)",
    "roofline_report": "it reads the JAX package's TPU dry-run artefacts; "
                       "the card has none",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    t0 = time.time()

    from repro_torch.harness import (fig18_dedup, fig19_split, fig20_ramp,
                                     fig_faults, quickstart, tab_schemes)

    length = 48 if args.fast else 96
    dev = args.device
    tab_schemes.run(device=dev)
    fig18_dedup.run(length=length, device=dev)
    fig19_split.run(length=length, device=dev)
    fig20_ramp.run(length=length, device=dev)
    fig_faults.run(smoke=args.fast, device=dev)
    quickstart.main(device=dev)
    print("\nnot run (not in the port yet):")
    for names, why in NOT_PORTED.items():
        print(f"  - {names}: {why}")
    print(f"\nall harnesses done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
