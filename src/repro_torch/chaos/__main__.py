"""CLI: ``python -m repro_torch.chaos [--smoke] [--seed S] [--cases N]
[--device DEV] [--preset smoke|full]``.

Runs one seeded chaos campaign against the serving engine and the
emulator pair, prints the per-case verdicts, and on failure shrinks each
failing case (on a harness of the same settings) to a minimal repro
schedule before exiting nonzero.  ``--smoke`` is the CI entry point
(small case count, both halves).  The serving half runs on the card
unless ``--device cpu`` is given; ``--preset full`` serves the model at
full width and 4 layers.
"""

from __future__ import annotations

import argparse
import sys
from functools import partial

from .campaign import (ChaosHarness, case_fails, generate_campaign,
                       run_campaign)
from .shrink import shrink_case


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.chaos",
        description="deterministic chaos campaign over the fault-tolerant "
                    "serving stack")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cases", type=int, default=8)
    p.add_argument("--smoke", action="store_true",
                   help="small CI campaign (4 cases)")
    p.add_argument("--no-serve", action="store_true",
                   help="skip the serving-engine half")
    p.add_argument("--no-emulator", action="store_true",
                   help="skip the emulator-lockstep half")
    p.add_argument("--no-shrink", action="store_true",
                   help="report failures without reducing them")
    p.add_argument("--device", default=None,
                   help="the serving half's device (default: the card)")
    p.add_argument("--preset", default="smoke", choices=("smoke", "full"),
                   help="the model's widths (full: 4 of its layers)")
    args = p.parse_args(argv)

    settings = dict(preset=args.preset, device=args.device)
    n_cases = 4 if args.smoke else args.cases
    report = run_campaign(args.seed, n_cases, serve=not args.no_serve,
                          emulator=not args.no_emulator, log=print,
                          **settings)
    print(report.summary())
    ok = report.ok
    if args.smoke and not args.no_serve:
        # one extra case through the overlapped executor: the same
        # invariants must hold with 2 micro-batches in flight
        ov = run_campaign(args.seed, 1, serve=True, emulator=False,
                          overlap=True,
                          log=lambda m: print(f"overlap {m}"), **settings)
        print("overlap " + ov.summary())
        ok = ok and ov.ok
    if ok:
        return 0

    if not args.no_shrink:
        cases = {c.cid: c for c in generate_campaign(args.seed, n_cases)}
        harness = None if args.no_serve else ChaosHarness(
            seed=args.seed, **settings)
        fails = partial(case_fails, harness,
                        emulator=not args.no_emulator)
        for res in report.failing:
            small = shrink_case(cases[res.cid], fails)
            print(f"minimal repro for {res.cid} "
                  f"(seed={args.seed}): wire={list(small.wire)} "
                  f"kill={small.kill} emu={list(small.emu)}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
