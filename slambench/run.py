#!/usr/bin/env python3
"""The benchmark of myslam_torch's SLAM loop: one run of one cell.

    python3 slambench/run.py --workload replica_dense --seed 7 \\
        --seconds 10 --trace 0

prints, as the last line of its standard output, one JSON object: the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``), whether the check found the program's steps correct, the
device, and each compared number beside its limit (also the last lines of
its standard error).  It needs an NVIDIA GPU and exits non-zero, printing
no result, without one.  ``--rehearse`` runs the cell cut to a tiny size
on the CPU, its device metrics marked not measured; ``--control`` turns
on the program's bfloat16 map reads, which the check has to refuse.
See slambench/README.md.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root, in place of this file's folder: the benchmark's
# modules are imported as the package ``slambench``.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from slambench import harness  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--control", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    harness.cache_env()
    import torch

    if not args.rehearse:
        cell = harness.load_cell(args.workload)["cell"]
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < int(cell["chips"])):
            print(f"slambench: {args.workload} needs {cell['chips']} CUDA "
                  "device(s); none or too few are visible", file=sys.stderr)
            return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), rehearse=args.rehearse,
                              control=args.control, t_start=T_START)
    line = harness.metric_line(args.workload, result, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"slambench: the run loaded {found}", file=sys.stderr)
        return 4
    run = result["run"]
    print(f"slambench: {args.workload} seed {args.seed}: "
          f"{run['frames']} frames in {run['window_s']:.3f} s, set-up "
          f"{run['setup_s']:.3f} s, check {run['check_s']:.3f} s, ATE "
          f"{run['ate_cm']:.4f} cm, frame source "
          f"{run['source_ms_per_frame']:.3f} ms/frame of CPU "
          f"({run['source_wall_ms_per_frame']:.3f} wall), holes "
          f"{run['hole_share']:.4f}; frame ms "
          f"{[round(x, 1) for x in run['frame_ms'] if x]}", file=sys.stderr)
    host = run["host"]
    print("slambench: window host figures: " + ", ".join(
        f"{k} {v!r}" for k, v in host.items()), file=sys.stderr)
    if "trace_frames_per_s" in run:
        tr = run["trace_frames_per_s"]
        print(f"slambench: traced groups {tr['device']:.4f} frames/s under "
              f"the device's trace, {tr['host']:.4f} under the host's",
              file=sys.stderr)
    for name in run["left_out"]:
        print(f"slambench: {name} not measured (its reader found nothing "
              "to read): left out of the line", file=sys.stderr)
    for name, v in run["not_compared"].items():
        print(f"{name} {v!r} (not compared in this cell)", file=sys.stderr)
    for name, v in line["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
