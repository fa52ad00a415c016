#!/usr/bin/env python3
"""Benchmark: end-to-end SLAM throughput of the PyTorch/CUDA port on the
synthetic room workload.

    python bench_torch.py                    # both lanes, 120 frames, GPU
    python bench_torch.py --lanes exact --frames 13 --warmup-frames 5

The port of ``bench.py``.  It runs the full tracking and mapping loop at
the reference's Replica operating point (680x1200 RGB-D, 2000 tracking
px x 8 iterations, 4000 mapping px x 15 iterations every 4th frame, 40
samples per ray) in both math lanes by default:

  * top-K color (``color_topk: 12`` as configs/Synthetic/room.yaml sets
    it): the headline lane;
  * reference-exact (color composited at every sample,
    ``color_topk: 0``, f32 map reads): run first, in a subprocess of its
    own, so each lane has a fresh process, allocator and kernel build;

and prints one JSON line whose top-level fields are the headline lane's,
with both lanes under ``"lanes"``.  Throughput is window-level: frames
from the first one after the warmup to the drain of the device queue,
over that span.  ATE is over frames 1 onwards.  After the line, outside
the timed window, the final checkpoint and (``--mesh``) the final mesh
are written, their messages on stderr; a failure there raises and the
run exits non-zero, the metric line already printed.

``vs_baseline`` compares with REFERENCE_FPS, the reference ESLAM's
end-to-end Replica throughput estimated from its paper (~0.18 s/frame on
an RTX 3090-class GPU, arXiv 2211.11704).

The run goes on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REFERENCE_FPS = 5.5
BASELINE_KIND = "estimate(paper, RTX3090-class)"
REPO = os.path.dirname(os.path.abspath(__file__))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--warmup-frames", type=int, default=24,
                   help="frames excluded from timing (frame 0's mapping, "
                   "kernel builds)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny fast configuration for quick checks")
    p.add_argument("--output", type=str,
                   default=os.path.join(REPO, "output", "bench_torch"))
    p.add_argument("--cold-threshold-s", type=float, default=90.0,
                   help="frame-0 wall above this means a cold start")
    p.add_argument("--mesh", choices=("auto", "on", "off"), default="auto",
                   help="final meshing after the metric line: auto skips "
                   "it after a cold start (the metric is printed either "
                   "way)")
    p.add_argument("--lanes", choices=("both", "topk", "exact"),
                   default="both",
                   help="math lanes to run; 'both' (default) nests the "
                   "reference-exact lane's numbers beside the top-K "
                   "headline in the one JSON line")
    p.add_argument("--exact", action="store_true",
                   help="alias for --lanes exact")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--map-bf16", action="store_true",
                   help="bf16 quad-atlas reads in the mapping step "
                   "(mapping.map_bf16)")
    p.add_argument("--topk", type=int, default=-1,
                   help="override rendering.color_topk for the top-K lane "
                   "(investigation only)")
    p.add_argument("--config", type=str, default=None,
                   help="alternate scene yaml; default "
                   "configs/Synthetic/room[_smoke].yaml")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    if args.exact:
        args.lanes = "exact"
    return args


def lane_config(args, exact: bool) -> dict:
    """The run's config in one math lane (the lane rules of bench.py)."""
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    scene = "room_smoke.yaml" if args.smoke else "room.yaml"
    cfg = load_config(args.config or os.path.join(
        REPO, "configs", "Synthetic", scene), DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = args.frames
    if exact:
        # The reference's math end to end: f32 map reads too
        # (--map-bf16 re-enables them for investigation).
        cfg["rendering"]["color_topk"] = 0
        cfg["mapping"]["map_bf16"] = False
    if args.topk >= 0 and not exact:
        cfg["rendering"]["color_topk"] = args.topk
    if args.map_bf16:
        cfg["mapping"]["map_bf16"] = True
    return cfg


def run_lane(args, exact: bool, seed: int = 0):
    """One full SLAM run in the given math lane, without finalization;
    returns (record, slam)."""
    from myslam_torch.engine.scheduler import SLAMSystem

    out = args.output + ("_exact" if exact else "")
    slam = SLAMSystem(lane_config(args, exact), output=out, seed=seed,
                      device=args.device)
    # Drain the device at the warmup boundary so the timed window holds
    # no backlog from the heavy first-frame mapping.
    slam.sync_after_frame = args.warmup_frames - 1
    t0 = time.perf_counter()
    slam.run(finalize=False)
    wall = time.perf_counter() - t0

    # Window-level throughput: from the start of the first frame after
    # the warmup to the drain (per-frame host times would miss the work
    # still queued on the device).
    w = min(args.warmup_frames, len(slam.frame_start_wall) - 1)
    span = slam.drain_wall - slam.frame_start_wall[w]
    n_steady = len(slam.frame_start_wall) - w
    fps = n_steady / span if span > 0 else 0.0
    frame_ms = [r["frame_ms"] for r in slam.frame_log]

    t_err = np.linalg.norm(
        slam.estimates[1:, :3, 3] - slam.gt_poses[1:, :3, 3], axis=-1)
    ate_rmse_cm = float(np.sqrt(np.mean(t_err ** 2)) * 100)
    frame0_wall = frame_ms[0] / 1e3 if frame_ms else 0.0

    rec = {
        "math": ("reference-exact (color_topk 0)" if exact
                 else "top-K color (validated approximation)"),
        "value": round(float(fps), 3),
        "unit": "frames/s",
        "vs_baseline": round(float(fps) / REFERENCE_FPS, 3),
        "baseline_kind": BASELINE_KIND,
        "ate_rmse_cm": round(ate_rmse_cm, 3),
        "frames": len(frame_ms),
        "wall_s": round(wall, 1),
        "frame0_wall_s": round(frame0_wall, 1),
        "compile_backend_s": round(float(slam.compile_secs), 1),
        "cache": ("cold" if frame0_wall > args.cold_threshold_s
                  else "warm"),
    }
    return rec, slam


def _exact_lane_subprocess(args) -> dict:
    """The exact lane in a fresh process; its record, or the error."""
    cmd = [sys.executable, os.path.abspath(__file__),
           "--lanes", "exact", "--mesh", "off",
           "--frames", str(args.frames),
           "--warmup-frames", str(args.warmup_frames),
           "--seed", str(args.seed),
           "--cold-threshold-s", str(args.cold_threshold_s),
           "--output", args.output + "_exactlane"]
    for flag, on in (("--smoke", args.smoke), ("--map-bf16", args.map_bf16)):
        if on:
            cmd.append(flag)
    for flag, val in (("--config", args.config), ("--device", args.device)):
        if val:
            cmd += [flag, val]
    try:
        out = subprocess.run(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, timeout=max(1800, 600 + 15 * args.frames)).stdout
        rec = next(json.loads(ln) for ln in out.splitlines()
                   if ln.startswith("{"))
        for key in ("lanes", "metric", "final_mesh"):
            rec.pop(key, None)
        return rec
    except Exception as e:  # the headline lane must survive
        return {"error": repr(e)}


def main(argv=None) -> dict:
    args = parse_args(argv)
    headline_exact = args.lanes == "exact"
    lanes = {}
    if args.lanes == "both":
        lanes["exact"] = _exact_lane_subprocess(args)
    rec, slam = run_lane(args, exact=headline_exact, seed=args.seed)
    lanes["exact" if headline_exact else "topk"] = dict(rec)
    cold = rec["cache"] == "cold"
    do_mesh = args.mesh == "on" or (args.mesh == "auto" and not cold)
    line = {
        "metric": ("synthetic_room_e2e_frames_per_s_exact" if headline_exact
                   else "synthetic_room_e2e_frames_per_s"),
        **rec,
        "lanes": lanes,
        "final_mesh": ("pending" if do_mesh else
                       "skipped(cold-cache)" if args.mesh == "auto"
                       else "skipped(--mesh off)"),
    }
    print(json.dumps(line), flush=True)

    # The checkpoint and the mesh after the metric line; their messages
    # go to stderr so the metric stays the only line on stdout.
    with contextlib.redirect_stdout(sys.stderr):
        t1 = time.perf_counter()
        path = slam.finalize(mesh=do_mesh, checkpoint=True)
        print(f"checkpoint {path}, mesh {slam.final_mesh} "
              f"({time.perf_counter() - t1:.1f} s)")
    return line


if __name__ == "__main__":
    main()
