#!/usr/bin/env python
"""Where one steady group of the SLAM loop spends its time on the GPU.

    python -m myslam_torch.tools.profile_steps [--config PATH] [--exact]

Runs ``SLAMSystem`` for 13 frames and traces, with
``torch.profiler``, the last every_frame group: its tracked frames and
the mapped frame that closes it.  Prints one JSON line with the window's
wall time, the device's busy time (kernels and copies) and idle share,
the kernel count, and the operators, kernels and kernel families (a
template's instantiations summed) that hold the most device time.
The profiler adds host time to every operator, so the traced window's
wall and idle share are upper bounds; the untraced per-frame times of
the same run are printed beside them (``frame_log``).
"""

from __future__ import annotations

import argparse
import json
import re
import time

N_FRAMES = 13  # frame 0, then three groups of four
TOP = 15


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/Synthetic/room.yaml")
    p.add_argument("--exact", action="store_true",
                   help="the exact lane: every color sample, f32 map reads "
                        "in mapping (bench_torch.py's lane rule)")
    args = p.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    cfg = load_config(args.config, DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = N_FRAMES
    if args.exact:
        cfg["rendering"]["color_topk"] = 0
        cfg["mapping"]["map_bf16"] = False
    slam = SLAMSystem(cfg, device="cuda")
    every = slam.every_frame
    last = (N_FRAMES - 1) // every * every
    if last - every <= 0:
        raise ValueError("needs two mapped frames after frame 0")
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    window = {}

    def hook(system, idx):
        # Trace from the mapped frame before the last group to its end.
        if idx == last - every:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        elif idx == last:
            torch.cuda.synchronize()
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.stop()

    slam.on_map_done = hook
    slam.run_loop()

    # Device-side events, without the ranges of user annotations (such as
    # the optimizer's step), which span kernels already counted.
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy_us = sum(e.device_time_total for e in kernels)
    by_kernel: dict = {}
    for e in kernels:
        n, t = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, t + e.device_time_total)
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    by_family: dict = {}
    for name, (n, t) in by_kernel.items():
        family = re.split(r"[<(]", re.sub(r"^void ", "", name), 1)[0]
        fn, ft = by_family.get(family, (0, 0.0))
        by_family[family] = (fn + n, ft + t)
    top_families = sorted(by_family.items(), key=lambda kv: -kv[1][1])
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    group = [r for r in slam.frame_log if last - every < r["frame"] <= last]
    untraced = [r for r in slam.frame_log
                if last - 2 * every < r["frame"] <= last - every]
    out = {
        "config": args.config, "exact": args.exact, "frames": N_FRAMES,
        "device": torch.cuda.get_device_name(0),
        "window_frames": [r["frame"] for r in group],
        "traced_wall_ms": window["wall_ms"],
        "untraced_group_ms": sum(r.get("track_ms", 0.0) + r.get("map_ms", 0.0)
                                 for r in untraced),
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / 1e3 / window["wall_ms"],
        # The same device work against the untraced group's wall.
        "idle_share_untraced": 1.0 - busy_us / 1e3 / sum(
            r.get("track_ms", 0.0) + r.get("map_ms", 0.0) for r in untraced),
        "kernels": len(kernels),
        "iterations": (every * int(cfg["tracking"]["iters"])
                       + int(cfg["mapping"]["iters"])),
        "top_ops": [{"name": e.key, "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in ops[:TOP]],
        "top_kernels": [{"name": name[:120], "count": n, "device_ms": t / 1e3}
                        for name, (n, t) in top_kernels[:TOP]],
        "top_families": [{"name": name[:120], "count": n,
                          "device_ms": t / 1e3, "share": t / busy_us}
                         for name, (n, t) in top_families[:TOP]],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
