"""Run a cell with a control or a fault planted in the program, on several
seeds in one process, and print each seed's checks: the readings that set
the limits.  The benchmark's own runs never run this.

    python3 -m benchmark.control --workload <cell> --plant <name> \\
        --seconds <s> --seeds <n> [<n> ...]

``--plant none`` gives the sound program's readings, for comparison; the
names are ``faults.PLANTS``'.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

from . import faults, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--plant", required=True,
                    choices=["none"] + sorted(faults.PLANTS))
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    os.environ["DOWNPORE_TORCH_DEVICE"] = "cuda"
    man = run.manifest()
    for seed in args.seeds:
        plant = (contextlib.nullcontext() if args.plant == "none"
                 else faults.plant(args.plant))
        with plant:
            res = run.run_cell(args.workload, seed, args.seconds, False,
                               man=man)
        print(json.dumps({"workload": args.workload, "plant": args.plant,
                          "seed": seed, "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
