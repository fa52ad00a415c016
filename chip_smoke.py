#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

  1. build   -- compile the CUDA kernels from myslam_torch/csrc;
  2. kernels -- kernel K1 (tri-plane sample forward) and K2 (its backward)
                against their plain PyTorch versions at the main path's
                shapes (mapping: 160,000 SDF and 48,000 color points;
                f32 and bf16 quads), with their times, the plain
                versions' times, a library yardstick and the bound;
  3. slam    -- the main path: SLAMSystem on configs/Synthetic/room.yaml
                at full width for 13 frames (frame 0 mapped for 1000
                iterations, 12 tracked frames, frames 4, 8 and 12
                mapped), with per-frame times, launch counts and ATE.

Then the card's name and power limit, the kernels line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero without that last line; so does a machine without
a GPU.  There is no CPU path.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

N_FRAMES = 13
SEED = 0
DEVICE = "cuda"
# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Launch counts of the main path: per tracking and per mapping iteration,
# one SDF sample and one top-K color sample, each differentiated once.
SAMPLES_PER_ITER = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scaled_err(got, ref) -> tuple[float, float]:
    """(max abs error, max abs error over max |ref|)."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-30)


def main_scene(cfg):
    from myslam_torch.models.planes import compute_bound, make_layout

    bound = compute_bound(cfg)
    c = int(cfg["model"]["c_dim"])
    p, q = cfg["planes_res"], cfg["c_planes_res"]
    return (make_layout(bound, [p["coarse"], p["fine"]], c),
            make_layout(bound, [q["coarse"], q["fine"]], c))


def grid_sample_features(planes, layout, p_nor):
    """The library yardstick: the reduced features (N, L*C) by six
    F.grid_sample calls (bilinear, border, align_corners=True) and the
    orientation sum.  The port never calls this."""
    import torch
    import torch.nn.functional as F

    from myslam_torch.models.planes import ORIENTATIONS

    feats = []
    for lvl in range(layout.n_levels):
        acc = 0
        for ori, (au, av) in enumerate(ORIENTATIONS):
            grid = p_nor[:, [au, av]][None, :, None, :]
            acc = acc + F.grid_sample(
                planes[lvl * 3 + ori], grid, mode="bilinear",
                padding_mode="border", align_corners=True)[0, :, :, 0].t()
        feats.append(acc)
    return torch.cat(feats, dim=-1)


def check_kernels(layouts) -> list[dict]:
    """K1 and K2 against their plain versions; returns one record per
    (layout, dtype) case."""
    import torch

    from myslam_torch.ops import cuda_sample
    from myslam_torch.ops.plane_sample import pack_quad

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    for name, layout, n in (("sdf", layouts[0], 160_000),
                            ("color", layouts[1], 48_000)):
        C, L = layout.c_dim, layout.n_levels
        atlas = 0.01 * torch.randn((layout.total_rows, C), generator=gen,
                                   device=dev)
        # Past [-1, 1] on purpose: the border clamp and its zero
        # coordinate gradient are part of what is checked.
        p_nor = (torch.rand((n, 3), generator=gen, device=dev) * 2.1
                 - 1.05).contiguous()
        gbar = torch.randn((n, L * 4 * C), generator=gen, device=dev)
        planes = [atlas[off:off + H * W].reshape(H, W, C).permute(2, 0, 1)
                  [None].contiguous().requires_grad_()
                  for _, _, _, _, H, W, off in layout.planes()]
        grid_in = p_nor.clone().requires_grad_()
        lib_out = grid_sample_features(planes, layout, grid_in)
        lib_gbar = torch.randn_like(lib_out)
        for dtype in (torch.float32, torch.bfloat16):
            quad = pack_quad(atlas, layout).to(dtype).contiguous()
            out = cuda_sample.plane_sample_fwd(quad, layout, p_nor)
            ref = cuda_sample.plane_sample_fwd_ref(quad, layout, p_nor)
            qg, pg = cuda_sample.plane_sample_bwd(gbar, quad, layout, p_nor)
            rqg, rpg = cuda_sample.plane_sample_bwd_ref(gbar, quad, layout,
                                                        p_nor)
            torch.cuda.synchronize()
            f_err, f_rel = scaled_err(out, ref)
            q_err, q_rel = scaled_err(qg, rqg)
            p_err, p_rel = scaled_err(pg, rpg)
            # Tolerance: the same float32 products summed in another order
            # (FMA contraction; atomics against index_add_; a warp
            # reduction against torch.sum): 1e-5 of the largest value.
            for what, rel in (("forward", f_rel), ("quad_grad", q_rel),
                              ("p_grad", p_rel)):
                if not rel <= 1e-5:
                    raise AssertionError(
                        f"{name} {dtype} {what}: error {rel:.3e} of the "
                        f"largest value exceeds 1e-5")
            # Points outside the bound on every axis get no coordinate
            # gradient from the clamped planes.
            out_all = (p_nor.abs() > 1.0).all(dim=1)
            if bool(out_all.any()) and float(pg[out_all].abs().max()) != 0:
                raise AssertionError(f"{name}: p_grad outside the border")

            elt = quad.element_size()
            q_bytes = layout.total_rows * 4 * C * elt
            io = n * 3 * 4
            feat = n * L * 4 * C * 4
            fwd_bytes = io + q_bytes + feat
            bwd_bytes = feat + io + q_bytes + layout.total_rows * 4 * C * 4 \
                + n * 3 * 4
            lanes = n * 3 * L * 4 * C  # (point, plane, lane)
            fwd_ops, bwd_ops = 2 * lanes, 7 * lanes
            # K2 with the quad gradient; the frozen-quad variant too.
            ms_fwd = time_ms(lambda: cuda_sample.plane_sample_fwd(
                quad, layout, p_nor))
            ms_bwd = time_ms(lambda: cuda_sample.plane_sample_bwd(
                gbar, quad, layout, p_nor))
            ms_bwd_p = time_ms(lambda: cuda_sample.plane_sample_bwd(
                gbar, quad, layout, p_nor, need_quad_grad=False))
            plain_fwd = time_ms(lambda: cuda_sample.plane_sample_fwd_ref(
                quad, layout, p_nor), reps=5)
            plain_bwd = time_ms(lambda: cuda_sample.plane_sample_bwd_ref(
                gbar, quad, layout, p_nor), reps=5)
            lib_fwd = time_ms(lambda: grid_sample_features(
                planes, layout, grid_in), reps=5)
            lib_bwd = time_ms(lambda: torch.autograd.grad(
                lib_out, planes + [grid_in], lib_gbar, retain_graph=True),
                reps=5)

            def bound(nbytes, ops):
                t_b = nbytes / HBM_BYTES_PER_S * 1e3
                t_o = ops / F32_FLOPS * 1e3
                return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

            fb, fby = bound(fwd_bytes, fwd_ops)
            bb, bby = bound(bwd_bytes, bwd_ops)
            cases.append({
                "layout": name, "rows": layout.total_rows, "points": n,
                "quad_dtype": str(dtype).replace("torch.", ""),
                "fwd": {"max_abs_err": f_err, "ms": ms_fwd,
                        "plain_ms": plain_fwd, "library_ms": lib_fwd,
                        "bytes": fwd_bytes, "bound_ms": fb, "bound_by": fby},
                "bwd": {"max_abs_err": max(q_err, p_err),
                        "quad_grad_err": q_err, "p_grad_err": p_err,
                        "ms": ms_bwd, "ms_p_grad_only": ms_bwd_p,
                        "plain_ms": plain_bwd, "library_ms": lib_bwd,
                        "bytes": bwd_bytes, "bound_ms": bb, "bound_by": bby},
            })
            emit({"phase": "kernels", **cases[-1]})
    return cases


def run_slam(cfg) -> dict:
    import numpy as np
    import torch

    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.ops import cuda_sample

    slam = SLAMSystem(cfg, seed=SEED, device=DEVICE)
    t_iters = int(cfg["tracking"]["iters"])
    # Launches per group (its tracked frames and the mapped frame that
    # closes it), read after each mapped frame.
    groups = []

    def count_group(system, idx):
        recs = [r for r in system.frame_log
                if r["frame"] > (groups[-1]["frame"] if groups else -1)]
        n_it = (t_iters * sum("track_loss_first" in r for r in recs)
                + recs[-1]["map_iters"])
        groups.append({"frame": idx, "iterations": n_it,
                       "launches": dict(cuda_sample.LAUNCHES)})

    slam.on_map_done = count_group
    cuda_sample.reset_launches()
    t0 = time.perf_counter()
    slam.run_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_sample.LAUNCHES)

    tracked = [r for r in slam.frame_log if "track_ms" in r]
    mapped = [r for r in slam.frame_log if "map_ms" in r]
    for r in slam.frame_log:
        emit({"phase": "slam_frame", **r})
    before = {name: 0 for name in launches}
    for g in groups:
        for name, count in g["launches"].items():
            grown = count - before[name]
            if grown != SAMPLES_PER_ITER * g["iterations"]:
                raise AssertionError(
                    f"{name}: {grown} launches in the group ending at frame "
                    f"{g['frame']}, expected {SAMPLES_PER_ITER} per each of "
                    f"its {g['iterations']} iterations")
        before = g["launches"]
    expected = SAMPLES_PER_ITER * (t_iters * len(tracked)
                                   + sum(r["map_iters"] for r in mapped))
    if launches != {name: expected for name in launches} or expected == 0:
        raise AssertionError(f"launches {launches}, expected {expected} each")
    losses = [v for r in slam.frame_log for k, v in r.items()
              if "loss" in k]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite loss on the main path")
    est = slam.estimates
    if est.shape != (N_FRAMES, 4, 4) or not np.isfinite(est).all():
        raise AssertionError("trajectory is not finite")
    ate_cm = slam.ate()["absolute_translational_error.rmse"] * 100.0
    # The JAX package reaches well under 1 cm on this scene; a broken
    # tracker drifts by centimeters within a few frames.
    if not ate_cm < 2.0:
        raise AssertionError(f"ATE {ate_cm:.3f} cm on {N_FRAMES} frames")
    out = {
        "phase": "slam", "config": "configs/Synthetic/room.yaml",
        "frames": N_FRAMES, "cam": [slam.cam.H, slam.cam.W],
        "sdf_rows": slam.sdf_layout.total_rows,
        "color_rows": slam.color_layout.total_rows,
        "tracked_frames": len(tracked), "mapped_frames": len(mapped),
        "track_ms_mean": float(np.mean([r["track_ms"] for r in tracked])),
        "map_ms_steady_mean": float(np.mean(
            [r["map_ms"] for r in mapped if r["frame"] > 0])),
        "map_ms_frame0": mapped[0]["map_ms"],
        "wall_s": wall, "ate_rmse_cm": ate_cm, "launches": launches,
        "expected_launches": expected,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(out)
    return out


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from myslam_torch.ops import cuda_sample
        from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    cuda_sample.build()
    ptxas = [ln.strip() for ln in cuda_sample.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": cuda_sample.library_path(), "ptxas": ptxas})

    cfg = load_config("configs/Synthetic/room.yaml", DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = N_FRAMES
    cases = check_kernels(main_scene(cfg))
    slam = run_slam(cfg)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)

    # The kernels line: each kernel at the main path's heaviest call, the
    # mapping SDF sample (160,000 points) on bf16 quads (map_bf16 in
    # configs/Synthetic/room.yaml and in tracking).
    head = next(c for c in cases
                if c["layout"] == "sdf" and c["quad_dtype"] == "bfloat16")
    kernels = []
    for name, key, replaces in (
            ("plane_sample_fwd", "fwd",
             "myslam_tpu/ops/pallas_sample.py:160"),
            ("plane_sample_bwd", "bwd",
             "myslam_tpu/ops/plane_sample.py:343")):
        rec = head[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "myslam_torch/csrc/plane_sample.cu",
            "replaces": replaces, "launches": slam["launches"][name],
            "max_abs_err": max(c[key]["max_abs_err"] for c in cases),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
