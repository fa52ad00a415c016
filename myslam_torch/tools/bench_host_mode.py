#!/usr/bin/env python3
"""Keyframe-store placement bench: the float, packed and host-staged
stores on one sequence.

Runs the synthetic room (``configs/Synthetic/room.yaml``, 680x1200, by
default) with every frame mapped and admitted (``every_frame: 1``,
``keyframe_every: 1``, the TUM schedule's cadence) under each
``keyframe_device`` and prints one JSON line per mode: the steady
milliseconds per mapped frame (from the first frame after the warmup to
the device drain; frame 0 and the warmup are drained before that
window), frames/s, ATE, the device bytes of the store's imagery, and for
``host_staged`` the cache lines, cache misses and selection fetches.

    python -m myslam_torch.tools.bench_host_mode [--frames 28]
        [--warmup 8] [--modes tpu cpu host_staged] [--config PATH]
        [--device cpu] [--output DIR]

It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time


def run_mode(cfg: dict, mode: str, frames: int, warmup: int, output: str,
             device=None) -> dict:
    """One run of ``cfg`` with keyframe_device ``mode``; its record."""
    import torch

    from myslam_torch.engine.scheduler import SLAMSystem

    cfg = copy.deepcopy(cfg)
    cfg["data"]["n_frames"] = frames
    cfg["keyframe_device"] = mode
    cfg["mapping"]["every_frame"] = 1
    cfg["mapping"]["keyframe_every"] = 1
    slam = SLAMSystem(cfg, output=output, seed=0, device=device)
    slam.sync_after_frame = warmup - 1
    t0 = time.perf_counter()
    slam.run_loop()
    wall = time.perf_counter() - t0
    w = min(warmup, len(slam.frame_start_wall) - 1)
    span = slam.drain_wall - slam.frame_start_wall[w]
    n_steady = len(slam.frame_start_wall) - w
    rec = {
        "mode": mode, "store": slam.store.mode,
        "device": (torch.cuda.get_device_name(slam.device)
                   if slam.device.type == "cuda" else str(slam.device)),
        "frames": frames, "warmup": w,
        "cam": [slam.cam.H, slam.cam.W],
        "steady_ms_per_mapped_frame": span / n_steady * 1e3,
        "fps": n_steady / span,
        "ate_rmse_cm": slam.ate()["absolute_translational_error.rmse"]
        * 100.0,
        "store_imagery_bytes": slam.store.imagery_bytes(),
        "wall_s": wall,
    }
    if slam.store.host_mode:
        rec.update(cache_lines=slam.store.cache_lines,
                   cache_misses=slam.store.cache_misses,
                   selection_fetches=slam.selection_fetches)
    return rec


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=28)
    p.add_argument("--warmup", type=int, default=8)
    p.add_argument("--modes", nargs="+",
                   default=["tpu", "cpu", "host_staged"])
    p.add_argument("--config", default=os.path.join(
        "configs", "Synthetic", "room.yaml"))
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    p.add_argument("--output", default=os.path.join(
        "output", "bench_host_mode"))
    args = p.parse_args(argv)

    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    cfg = load_config(args.config, DEFAULT_CONFIG)
    out = []
    for mode in args.modes:
        rec = run_mode(cfg, mode, args.frames, args.warmup,
                       os.path.join(args.output, mode), args.device)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
