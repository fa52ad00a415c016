#!/usr/bin/env python
"""Milliseconds per mapping iteration against the ray count.

    python -m myslam_torch.tools.bench_raysweep [--config PATH]
        [--rays 4000,2000,1000,500,250] [--iters 15] [--reps 3] [--exact]
        [--device cpu] [--json] [--out FILE]

The counterpart of ``myslam_tpu/tools/bench_raysweep.py``: the real
15-iteration mapping window (``build_window``: ``make_frame_mapper``
over a full window of ``mapping_window_size`` keyframes, constant
imagery, every pose at the bound's center, selection and pose write-back
included, nothing admitted) is timed at each ray count R, and

    t_iter(R) = floor_ms + slope * R

is fitted by least squares (``fit_and_rows``).  The intercept is the
per-iteration cost that does not shrink with the rays (on the card: the
launches of a host-bound loop); the rows give the speedup a 1/n share of
the rays would see, against the linear 1/n.  ``--out`` has no default:
the repository root's ``raysweep.json`` is the JAX package's TPU record
and is never written.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_window(cfg: dict, device, seed: int = 0):
    """One mapped frame over a full keyframe window, repeatable: returns
    run(iters) -> losses, which maps the same frame again on the same
    store (admit off, so every call sees the same window), updating the
    map in place.  The map starts from ``seed``; ``mapping.pixels``,
    ``mapping.map_bf16`` and ``rendering.color_topk`` of ``cfg`` set the
    lane."""
    import torch

    from myslam_torch.core.sampling import TorchDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.engine.keyframes import KeyframeStore, \
        make_window_selector
    from myslam_torch.engine.mapper import make_frame_mapper
    from myslam_torch.models.config import get_model
    from myslam_torch.models.planes import init_map_state
    from myslam_torch.render.renderer import scene_from_cfg

    dev = torch.device(device)
    m = cfg["mapping"]
    cam = Camera.from_cfg(cfg)
    scene = scene_from_cfg(cfg)
    window = int(m["mapping_window_size"])
    w_max = window + 2
    capacity = window + 2  # the window's keyframes, a spare, the scratch
    store = KeyframeStore(capacity, cam, dev)
    store.colors[:window] = 0.5
    store.depths[:window] = 1.5
    c2w = torch.eye(4, device=dev)
    c2w[:3, 3] = scene.bound_tensor(dev).mean(dim=1)
    store.est_c2w[:] = c2w
    store.gt_c2w[:] = c2w
    store.count = window
    selector = make_window_selector(
        cam, capacity, window, w_max, capacity - 1,
        method=m.get("keyframe_selection_method", "overlap"))
    mapper = make_frame_mapper(cfg, scene, cam, selector, w_max,
                               capacity - 1, importance=False)
    gen = torch.Generator().manual_seed(seed)
    ms = init_map_state(gen, scene.sdf_layout, scene.color_layout,
                        get_model(cfg, gen), device=dev)
    est = c2w[None].clone()
    inv_q = 1.5 / 60000.0
    color_u8 = torch.full((cam.H, cam.W, 3), 128, dtype=torch.uint8,
                          device=dev)
    # Made on the host: CUDA has no cast kernel into uint16.
    depth_u16 = torch.full((cam.H, cam.W), 60000, dtype=torch.int32).to(
        torch.uint16).to(dev)
    draws = TorchDraws(seed, dev)

    def run(iters: int):
        return mapper(ms, store, est, color_u8, depth_u16, inv_q, c2w, 0,
                      draws, iters=iters, lr_factor=1.0, joint_opt=True,
                      admit=False)

    return run


def time_window(run, iters: int, reps: int, device) -> float:
    """Milliseconds per iteration of run(iters), over ``reps`` windows
    after one warmup window, to a synchronize (host clock)."""
    import torch

    from myslam_torch.tools.devtime import sync

    dev = torch.device(device)
    run(iters)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        run(iters)
    sync(dev)
    return (time.perf_counter() - t0) / reps / iters * 1e3


def fit_and_rows(rays, iter_ms):
    """Least-squares t(R) = floor + slope*R and the implied compute-only
    speedups of an n-way split of the rays against the linear n (a copy
    of the JAX tool's)."""
    A = np.stack([np.ones(len(rays)), np.asarray(rays, float)], axis=1)
    (floor, slope), *_ = np.linalg.lstsq(A, np.asarray(iter_ms), rcond=None)
    floor = float(max(floor, 0.0))
    slope = float(slope)
    r0 = max(rays)
    t0 = iter_ms[rays.index(r0)]
    rows = []
    for n in (1, 2, 4, 8, 16):
        share = r0 // n
        measured = (iter_ms[rays.index(share)]
                    if share in rays else floor + slope * share)
        rows.append({
            "chips": n,
            "rays_per_chip": share,
            "iter_ms_measured" if share in rays else "iter_ms_fit":
                round(measured, 3),
            "compute_speedup_measured": round(t0 / measured, 2),
            "compute_speedup_model_linear": n,
            "efficiency_vs_linear": round(t0 / measured / n, 3),
        })
    return floor, slope, rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(
        REPO, "configs", "Synthetic", "room.yaml"))
    ap.add_argument("--rays", type=str, default="4000,2000,1000,500,250")
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--exact", action="store_true",
                    help="also sweep the exact lane (color_topk 0, f32 "
                         "reads)")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' to rehearse")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    from myslam_torch import resolve_device
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    if args.out and os.path.abspath(args.out) == os.path.join(
            REPO, "raysweep.json"):
        raise SystemExit("raysweep.json at the repository root is the JAX "
                         "package's TPU record; write elsewhere")
    dev = resolve_device(args.device)
    cfg = load_config(args.config, DEFAULT_CONFIG)
    rays = [int(r) for r in args.rays.split(",")]
    lanes = [("topk_bf16" if cfg["mapping"].get("map_bf16") else "topk",
              cfg)]
    if args.exact:
        exact = copy.deepcopy(cfg)
        exact["mapping"]["map_bf16"] = False
        exact["rendering"]["color_topk"] = 0
        lanes.append(("exact", exact))

    import torch

    report = {"device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "config": args.config, "window_iters": args.iters,
              "reps": args.reps, "lanes": {}}
    for name, lane_cfg in lanes:
        iter_ms = []
        for r in rays:
            c = copy.deepcopy(lane_cfg)
            c["mapping"]["pixels"] = r
            ms = time_window(build_window(c, dev), args.iters, args.reps,
                             dev)
            iter_ms.append(ms)
            if not args.json:
                print(f"[{name}] R={r}: {ms:.3f} ms/iter", flush=True)
        floor, slope, rows = fit_and_rows(rays, iter_ms)
        report["lanes"][name] = {
            "rays": rays, "iter_ms": iter_ms,
            "fit_floor_ms": floor, "fit_slope_ms_per_ray": slope,
            "fit_floor_frac_of_max": floor / iter_ms[rays.index(max(rays))],
            "dp_compute_rows": rows,
        }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report) if args.json else json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
