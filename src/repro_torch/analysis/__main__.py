"""CLI: ``python -m repro_torch.analysis [--strict] [--layers ...]
[--write-certificates] [--device cpu]``.

Runs the three analysis layers and prints the findings one a line
(``[rule] location: message``). The exit status is 0 when clean; with
``--strict`` any finding exits 1.

``--write-certificates`` regenerates ``certificates.json`` from the live
tables (after a deliberate change to ``repro_torch.core.codes``; the
schemes layer fails while the saved document disagrees with the code).

The carry layer runs live programs at a small size on the card unless
``--device cpu`` is given, and raises without a card, as every entry
point does (a few seconds on a CPU); ``--layers schemes rules`` reads
source and tables only.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List

from repro_torch.analysis.base import Finding, format_findings

LAYERS = ("schemes", "carry", "rules")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant verification of the port")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any finding")
    ap.add_argument("--layers", nargs="+", choices=LAYERS, default=None,
                    help="subset of layers to run (default: all)")
    ap.add_argument("--write-certificates", action="store_true",
                    help="regenerate repro_torch/analysis/certificates.json "
                         "from the live tables, then verify")
    ap.add_argument("--device", default=None,
                    help="the carry layer's device (default: the card)")
    args = ap.parse_args(argv)

    if args.write_certificates:
        from repro_torch.analysis import schemes
        doc = schemes.write_certificates()
        print(f"wrote {schemes.CERT_PATH} "
              f"({len(doc['schemes'])} schemes, k<={doc['max_k']})")

    layers = args.layers or list(LAYERS)
    findings: List[Finding] = []
    for layer in layers:
        t0 = time.perf_counter()
        if layer == "schemes":
            from repro_torch.analysis import schemes
            got = schemes.run(strict=args.strict)
        elif layer == "carry":
            from repro_torch.analysis import carry
            got = carry.run(strict=args.strict, device=args.device)
        else:
            from repro_torch.analysis import rules
            got = rules.run(strict=args.strict)
        findings.extend(got)
        print(f"-- {layer}: {len(got)} finding(s) "
              f"[{time.perf_counter() - t0:.1f}s]", file=sys.stderr)

    if findings:
        print(format_findings(findings))
    else:
        print(f"analysis clean ({', '.join(layers)})")
    return 1 if (args.strict and findings) else 0


if __name__ == "__main__":
    sys.exit(main())
