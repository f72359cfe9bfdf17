"""Readings for the limits that decide ``correct``, many seeds in one process.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        [--variant int8-dit] [--fault half_batch] [--out FILE]

Each seed is one run of the cell through the harness (set-up without the
warm unit, a window of one unit, the check against the reference), so a
dozen seeds pay the process's start once. ``--variant`` runs a control (the
program's int8 modes, or the reference in the program's place with float8 or
int4 DiT linears, float8 VAE convolutions (``fp8-vae``) or, for training,
in float8), ``--fault`` plants a fault; both only here and in the tests. Prints,
and appends to ``--out``, one JSON line a seed: the seed, the card, the
numbers compared and the end-to-end metrics.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, peaks

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    card = peaks.card()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = harness.run(args.workload, seed, 0.0, False, device="cuda",
                          variant=args.variant, fault=args.fault, warm=False)
        rec = {"workload": args.workload, "seed": seed, "variant": args.variant,
               "fault": args.fault, "card": card, "run_s": time.time() - t0,
               "checks": {k: c["value"] for k, c in out["checks"].items()},
               "metrics": {k: m["value"] for k, m in out["metrics"].items()}}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
