#!/usr/bin/env python3
"""Readings for the check's limits: one cell run on many seeds in one
process (the kernels built once), the compared numbers and the window's
figures of each seed as one JSON line.  The benchmark's own runs never
run this.

    python3 slambench/calibrate.py --workload replica_dense \\
        --seeds 101,102,103 --seconds 4 [--control] [--out FILE]

``--control`` switches on the program's bfloat16 map reads, the control
the check has to refuse.
"""

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from slambench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.cache_env()
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.time()
            res = harness.run_cell(args.workload, seed, args.seconds, False,
                                   rehearse=args.rehearse,
                                   control=args.control)
            run = res["run"]
            line = {"workload": args.workload, "seed": seed,
                    "control": args.control, "correct": run["correct"],
                    "frames": run["frames"], "window_s": run["window_s"],
                    "frames_per_s": run["frames"] / run["window_s"],
                    "frame0_s": run["frame0_s"], "check_s": run["check_s"],
                    "ate_cm": run["ate_cm"], "seconds": time.time() - t0,
                    "compared": {**{k: v["value"]
                                    for k, v in run["compared"].items()},
                                 **run["not_compared"]}}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
