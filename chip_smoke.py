#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

  1. build        -- compile the CUDA kernels from myslam_torch/csrc, one
                     nvcc per source, all at once, into one library;
  2. kernels      -- K1 (tri-plane sample forward) and K2 (its backward)
                     against their plain PyTorch versions at the SLAM
                     loop's shapes (mapping: 160,000 SDF and 48,000 color
                     points, f32 and bf16 quads; the exact lane's 160,000
                     color points, f32), on uniform points and, for K2,
                     also on the loop's own ray-ordered points (with
                     tracking's 80,000 frozen-quad points) with the
                     host-counted row updates before and after merging
                     runs, and K3 (the forward with
                     the coarse level in shared memory) against its plain
                     version and K1 at the SDF shape (bf16: one block;
                     f32: a 2-block cluster), with their times, the plain
                     versions' times, a library yardstick and the bound;
  3. slam         -- the SLAM loop: SLAMSystem on configs/Synthetic/room.yaml
                     at full width for 13 frames (frame 0 mapped for 1000
                     iterations, 12 tracked frames, frames 4, 8 and 12
                     mapped), with per-frame times, K1/K2 launch counts
                     and ATE;
  4. bench_scatter -- K3's path: tools/bench_scatter.py's gather and
                     scatter sections at Replica room0 scale, one line per
                     strategy; K3 must agree with K1 and its plain version
                     on both room0 atlases and run in clusters of at
                     least 3 blocks;
  5. bench_exact  -- bench_torch.py's exact lane on room.yaml at full
                     width, cut to 13 frames (5 warmup): fps, ATE, K1/K2
                     launches, and its final checkpoint loaded back into a
                     fresh SLAMSystem bit for bit.

Then the card's name and power limit, the kernels line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero without that last line; so does a machine without
a GPU.  There is no CPU path.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

N_FRAMES = 13
SEED = 0
DEVICE = "cuda"
# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Launch counts of the SLAM loop: per tracking and per mapping iteration,
# one SDF sample and one color sample, each differentiated once, by K1
# and K2.  K3 is not on that path (bench_scatter drives it).
SAMPLES_PER_ITER = 2
SLAM_KERNELS = ("plane_sample_fwd", "plane_sample_bwd")
# The samples the kernels phase checks, (layout, rays, samples kept per
# ray (0: all 40), quad dtypes): the mapping samples of the top-K lane
# (SDF at all 40 samples of 4,000 rays, 160,000 points; color at the
# top 12, 48,000) and the exact lane's color sample at all 40 (f32 quad:
# map_bf16 is off there).  Each on uniform points and on the loop's own
# ray-ordered points of frame 0 (tools/bench_sample_bwd.loop_points).
KERNEL_CASES = (("sdf", 4000, 0, ("float32", "bfloat16")),
                ("color", 4000, 12, ("float32", "bfloat16")),
                ("color", 4000, 0, ("float32",)))
# Tracking's SDF sample (2,000 rays, 80,000 points, frozen bf16 quad):
# K2 without the quad gradient, on the loop's points.
TRACK_CASE = ("sdf", 2000, 0, ("bfloat16",))
# bench_scatter at room0 scale: points and timed repetitions.
BENCH_POINTS = 160_000
BENCH_ITERS = 10
EXACT_WARMUP = 5


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


def spills(build_log: str) -> dict:
    """Kernels whose ptxas report (-Xptxas -v) shows spill stores or
    loads: {mangled name: report line}."""
    out, fn = {}, None
    for ln in build_log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for")[-1].strip()
        elif "spill" in ln and fn is not None:
            if any(int(w) for w in re.findall(r"(\d+) bytes spill", ln)):
                out[fn] = ln.strip()
            fn = None
    return out


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for the work on the card, and what sets it."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_FLOPS * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def bwd_bound(n: int, layout, elt: int, rows: dict,
              quad_grad: bool) -> tuple[float, str, int]:
    """K2's bound on these points: gbar, the coordinates and p_grad once,
    the touched quad rows once, and with the quad gradient its touched
    rows written once; 7 (5 without the quad gradient) f32 operations per
    (point, plane, lane)."""
    C4, L = 4 * layout.c_dim, layout.n_levels
    nbytes = n * L * C4 * 4 + 2 * n * 3 * 4 + rows["rows_touched"] * C4 * (
        elt + (4 if quad_grad else 0))
    ms, by = bound_ms(nbytes, (7 if quad_grad else 5) * n * 3 * L * C4)
    return ms, by, nbytes


def check_bwd(gbar, quad, layout, p_nor, rows, planes) -> dict:
    """K2, with and without the quad gradient, against its plain version
    on these points; its times, the plain version's, the library's
    (grid_sample's backward, and with the planes frozen) and the bounds."""
    import torch

    from myslam_torch.ops import cuda_sample

    qg, pg = cuda_sample.plane_sample_bwd(gbar, quad, layout, p_nor)
    _, pg_only = cuda_sample.plane_sample_bwd(gbar, quad, layout, p_nor,
                                              need_quad_grad=False)
    rqg, rpg = cuda_sample.plane_sample_bwd_ref(gbar, quad, layout, p_nor)
    torch.cuda.synchronize()
    q_err, q_rel = scaled_err(qg, rqg)
    p_err, p_rel = scaled_err(pg, rpg)
    po_err, po_rel = scaled_err(pg_only, rpg)
    # Tolerance: the same float32 products summed in another order (FMA
    # contraction; runs merged in registers, then vector atomics, against
    # index_add_; a warp butterfly against torch.sum): 1e-5 of the
    # largest value.
    for what, rel in (("quad_grad", q_rel), ("p_grad", p_rel),
                      ("p_grad without quad_grad", po_rel)):
        if not rel <= 1e-5:
            raise AssertionError(
                f"K2 {layout.total_rows} rows {quad.dtype} {what}: error "
                f"{rel:.3e} of the largest value exceeds 1e-5")
    # Points outside the bound on every axis get no coordinate gradient
    # from the clamped planes.
    out_all = (p_nor.abs() > 1.0).all(dim=1)
    for got in (pg, pg_only):
        if bool(out_all.any()) and float(got[out_all].abs().max()) != 0:
            raise AssertionError("K2: p_grad outside the border")

    grid_in = p_nor.clone().requires_grad_()
    lib_out = grid_sample_features(planes, layout, grid_in)
    lib_gbar = torch.randn_like(lib_out)
    grid_fz = p_nor.clone().requires_grad_()
    lib_out_fz = grid_sample_features([q.detach() for q in planes], layout,
                                      grid_fz)
    n, elt = p_nor.shape[0], quad.element_size()
    bb, bby, nbytes = bwd_bound(n, layout, elt, rows, True)
    pb, pby, p_bytes = bwd_bound(n, layout, elt, rows, False)
    return {
        "max_abs_err": max(q_err, p_err, po_err), "quad_grad_err": q_err,
        "p_grad_err": p_err, "p_grad_only_err": po_err,
        "ms": time_ms(lambda: cuda_sample.plane_sample_bwd(
            gbar, quad, layout, p_nor)),
        "ms_p_grad_only": time_ms(lambda: cuda_sample.plane_sample_bwd(
            gbar, quad, layout, p_nor, need_quad_grad=False)),
        "plain_ms": time_ms(lambda: cuda_sample.plane_sample_bwd_ref(
            gbar, quad, layout, p_nor), reps=5),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            lib_out, planes + [grid_in], lib_gbar, retain_graph=True),
            reps=5),
        "bytes": nbytes, "bound_ms": bb, "bound_by": bby,
        "rows_touched": rows["rows_touched"],
        "p_grad_only": {
            "plain_ms": time_ms(lambda: cuda_sample.plane_sample_bwd_ref(
                gbar, quad, layout, p_nor, need_quad_grad=False), reps=5),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                lib_out_fz, [grid_fz], lib_gbar, retain_graph=True),
                reps=5),
            "bytes": p_bytes, "bound_ms": pb, "bound_by": pby},
    }


def check_kernels(cfg, layouts) -> list[dict]:
    """K1 and K2 (with and without the quad gradient) against their plain
    versions, and K3 against its plain version and K1 on the SDF layout;
    K2 also on the loop's own ray-ordered points, and on tracking's.
    Returns one record per (layout, points, dtype) case."""
    import torch

    from myslam_torch.ops import cuda_sample
    from myslam_torch.ops.plane_sample import pack_quad
    from myslam_torch.tools.bench_sample_bwd import loop_points, \
        row_updates, uniform_points

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    for name, n_rays, keep, dtypes in KERNEL_CASES + (TRACK_CASE,):
        layout = layouts[name]
        C, L = layout.c_dim, layout.n_levels
        track = (name, n_rays, keep, dtypes) == TRACK_CASE
        rays = loop_points(cfg, n_rays, dev, SEED, keep)
        n = rays.shape[0]
        atlas = 0.01 * torch.randn((layout.total_rows, C), generator=gen,
                                   device=dev)
        # Past [-1, 1] on purpose: the border clamp and its zero
        # coordinate gradient are part of what is checked.
        p_nor = uniform_points(n, gen, dev)
        gbar = torch.randn((n, L * 4 * C), generator=gen, device=dev)
        gbar_rays = torch.randn((n, L * 4 * C), generator=gen, device=dev)
        planes = [atlas[off:off + H * W].reshape(H, W, C).permute(2, 0, 1)
                  [None].contiguous().requires_grad_()
                  for _, _, _, _, H, W, off in layout.planes()]
        rows = {order: row_updates(layout, pts, cuda_sample.BWD_RUN)
                for order, pts in (("uniform", p_nor), ("rays", rays))}
        emit({"phase": "kernels_rows", "layout": name, "points": n,
              "run": cuda_sample.BWD_RUN, **rows})
        if not track:
            grid_in = p_nor.clone().requires_grad_()
            lib_fwd = time_ms(lambda: grid_sample_features(
                planes, layout, grid_in), reps=5)
        for dtype in (getattr(torch, d) for d in dtypes):
            quad = pack_quad(atlas, layout).to(dtype).contiguous()
            rec = {"layout": name, "rows": layout.total_rows, "points": n,
                   "quad_dtype": str(dtype).replace("torch.", "")}
            if track:
                # Tracking's sample: frozen quads, K2 without the quad
                # gradient (its record's p_grad_only).
                rec["case"] = "tracking"
                rec["bwd_rays"] = check_bwd(gbar_rays, quad, layout, rays,
                                            rows["rays"], planes)
                cases.append(rec)
                emit({"phase": "kernels", **rec})
                continue
            out = cuda_sample.plane_sample_fwd(quad, layout, p_nor)
            ref = cuda_sample.plane_sample_fwd_ref(quad, layout, p_nor)
            torch.cuda.synchronize()
            f_err, f_rel = scaled_err(out, ref)
            # Tolerance: the same float32 products, FMA-contracted: 1e-5
            # of the largest value.
            if not f_rel <= 1e-5:
                raise AssertionError(
                    f"{name} {dtype} forward: error {f_rel:.3e} of the "
                    f"largest value exceeds 1e-5")
            fwd_bytes = (n * 3 * 4 + layout.total_rows * 4 * C
                         * quad.element_size() + n * L * 4 * C * 4)
            fb, fby = bound_ms(fwd_bytes, 2 * n * 3 * L * 4 * C)
            plain_fwd = time_ms(lambda: cuda_sample.plane_sample_fwd_ref(
                quad, layout, p_nor), reps=5)
            rec["fwd"] = {"max_abs_err": f_err, "ms": time_ms(
                lambda: cuda_sample.plane_sample_fwd(quad, layout, p_nor)),
                "plain_ms": plain_fwd, "library_ms": lib_fwd,
                "bytes": fwd_bytes, "bound_ms": fb, "bound_by": fby}
            rec["bwd"] = check_bwd(gbar, quad, layout, p_nor,
                                   rows["uniform"], planes)
            rec["bwd_rays"] = check_bwd(gbar_rays, quad, layout, rays,
                                        rows["rays"], planes)
            cases.append(rec)
            if name == "sdf":
                rec["smem"] = check_smem(
                    quad, layout, p_nor, ref, out, plain_fwd, lib_fwd,
                    fwd_bytes, fb, fby)
            emit({"phase": "kernels", **rec})
    return cases


def check_smem(quad, layout, p_nor, ref, k1_out, plain_ms, lib_ms, nbytes,
               b_ms, b_by) -> dict:
    """K3 on the same inputs as K1: against the plain version and K1 (the
    same function, so the same bound, plain version and yardstick)."""
    import torch

    from myslam_torch.ops import smem_sample

    out = smem_sample.plane_sample_fwd_smem(quad, layout, p_nor)
    torch.cuda.synchronize()
    launch = dict(smem_sample.LAST_LAUNCH)
    err, rel = scaled_err(out, ref)
    _, rel_k1 = scaled_err(out, k1_out)
    # Tolerance: the same float32 products as the plain version and K1,
    # FMA-contracted: 1e-5 of the largest value.
    if not (rel <= 1e-5 and rel_k1 <= 1e-5):
        raise AssertionError(
            f"K3 {quad.dtype}: error {rel:.3e} against the plain version, "
            f"{rel_k1:.3e} against K1, of the largest value; limit 1e-5")
    want = smem_sample.coarse_cluster_blocks(layout, quad.dtype)
    if launch["cluster_blocks"] != want or want != (
            1 if quad.dtype == torch.bfloat16 else 2):
        raise AssertionError(f"K3 {quad.dtype}: cluster {launch}")
    return {"max_abs_err": err, "rel_err_vs_k1": rel_k1, **launch,
            "ms": time_ms(lambda: smem_sample.plane_sample_fwd_smem(
                quad, layout, p_nor)),
            "plain_ms": plain_ms, "library_ms": lib_ms, "bytes": nbytes,
            "bound_ms": b_ms, "bound_by": b_by}


def sample_calls(slam) -> list[dict]:
    """The samples a finished run made, each launching K1 and K2 once:
    per mapping iteration an SDF and a color sample whose backward makes
    the quad gradient, per tracking iteration both on frozen quads."""
    cfg, scene = slam.cfg, slam.scene
    t_iters = int(cfg["tracking"]["iters"])
    tracked = t_iters * sum("track_ms" in r for r in slam.frame_log)
    mapped = sum(r.get("map_iters", 0) for r in slam.frame_log)
    k = scene.color_topk if 0 < scene.color_topk < scene.n_samples \
        else scene.n_samples
    calls = []
    for step, launches, quad_grad in (("mapping", mapped, True),
                                      ("tracking", tracked, False)):
        rays = int(cfg[step]["pixels"])
        for layout, per_ray in (("sdf", scene.n_samples), ("color", k)):
            calls.append({"step": step, "layout": layout,
                          "points": rays * per_ray, "quad_grad": quad_grad,
                          "launches": launches})
    return calls


def expected_launches(slam) -> int:
    """K1 (and K2) launches a finished run must have made: one SDF and
    one color sample per tracking and per mapping iteration."""
    return sum(c["launches"] for c in sample_calls(slam))


def check_launches(launches: dict, expected: int) -> None:
    """K1 and K2 ran ``expected`` times each, K3 never (not on the SLAM
    loop's path)."""
    got = {name: launches[name] for name in SLAM_KERNELS}
    if (got != {name: expected for name in SLAM_KERNELS} or expected == 0
            or launches["plane_sample_fwd_smem"] != 0):
        raise AssertionError(f"launches {launches}, expected {expected} "
                             f"each of {SLAM_KERNELS} and no K3")


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
    before = {name: 0 for name in SLAM_KERNELS}
    for g in groups:
        for name in SLAM_KERNELS:
            grown = g["launches"][name] - before[name]
            if grown != SAMPLES_PER_ITER * g["iterations"]:
                raise AssertionError(
                    f"{name}: {grown} launches in the group ending at frame "
                    f"{g['frame']}, expected {SAMPLES_PER_ITER} per each of "
                    f"its {g['iterations']} iterations")
        before = g["launches"]
    expected = expected_launches(slam)
    check_launches(launches, expected)
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
        "expected_launches": expected, "calls": sample_calls(slam),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(out)
    return out


def run_bench_scatter() -> dict:
    """K3's path: the bench_scatter tool's gather and scatter sections at
    room0 scale, with K3's launches counted from zero."""
    from myslam_torch.ops import cuda_sample
    from myslam_torch.tools import bench_scatter

    cuda_sample.reset_launches()
    t0 = time.perf_counter()
    recs = bench_scatter.bench_gather(BENCH_POINTS, BENCH_ITERS, DEVICE,
                                      seed=SEED, log=lambda s: None)
    recs += bench_scatter.bench_scatter(BENCH_POINTS, BENCH_ITERS, DEVICE,
                                        seed=SEED, log=lambda s: None)
    wall = time.perf_counter() - t0
    launches = dict(cuda_sample.LAUNCHES)
    for rec in recs:
        emit({"phase": "bench_scatter", **rec})
    k3 = {r["atlas"]: r for r in recs if r.get("name") == "smem_bf16"}
    for atlas in ("sdf-atlas(0.06m)", "color-atlas(0.03m)"):
        rec = k3.get(atlas, {})
        # Tolerance: K3 against K1 and the plain version on the same bf16
        # quad, 1e-5 of the largest value.
        if "skipped" in rec or not (
                rec.get("rel_err_vs_k1_bf16", 1.0) <= 1e-5
                and rec.get("rel_err_vs_plain_bf16", 1.0) <= 1e-5):
            raise AssertionError(f"K3 on {atlas}: {rec}")
    if not k3["sdf-atlas(0.06m)"]["cluster_blocks"] >= 3:
        raise AssertionError(f"K3 on the room0 SDF atlas ran in a cluster "
                             f"of {k3['sdf-atlas(0.06m)']['cluster_blocks']}")
    if launches["plane_sample_fwd_smem"] == 0:
        raise AssertionError("K3 was not launched by bench_scatter")
    out = {"phase": "bench_scatter", "wall_s": wall, "launches": launches,
           "points": BENCH_POINTS, "iters": BENCH_ITERS}
    emit(out)
    return out


def run_bench_exact() -> dict:
    """bench_torch.py's exact lane, cut to N_FRAMES, then its final
    checkpoint loaded into a fresh SLAMSystem."""
    import numpy as np
    import torch

    import bench_torch
    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.ops import cuda_sample

    args = bench_torch.parse_args([
        "--lanes", "exact", "--frames", str(N_FRAMES),
        "--warmup-frames", str(EXACT_WARMUP), "--seed", str(SEED),
        "--device", DEVICE,
        "--output", os.path.join("output", "chip_smoke", "bench")])
    cuda_sample.reset_launches()
    rec, slam = bench_torch.run_lane(args, exact=True, seed=SEED)
    launches = dict(cuda_sample.LAUNCHES)
    check_launches(launches, expected_launches(slam))
    if not math.isfinite(rec["value"]) or rec["value"] <= 0:
        raise AssertionError(f"exact lane fps {rec['value']}")
    if not rec["ate_rmse_cm"] < 2.0:
        raise AssertionError(f"exact lane ATE {rec['ate_rmse_cm']} cm")

    t0 = time.perf_counter()
    path = slam.finalize(checkpoint=True)
    ckpt_s = time.perf_counter() - t0
    fresh = SLAMSystem(slam.cfg, output=slam.output, seed=SEED + 1,
                       device=DEVICE)
    start = fresh.resume()
    a, b = slam.map_state, fresh.map_state
    same = {
        "sdf_atlas": torch.equal(a.sdf_atlas, b.sdf_atlas),
        "color_atlas": torch.equal(a.color_atlas, b.color_atlas),
        "decoder": all(torch.equal(x, y) for x, y in zip(
            a.decoder.state_dict().values(),
            b.decoder.state_dict().values())),
        "trajectory": torch.equal(slam.est, fresh.est) and np.array_equal(
            slam.gt_poses, fresh.gt_poses),
    }
    if start != N_FRAMES or not all(same.values()):
        raise AssertionError(f"checkpoint {path}: start {start}, {same}")
    out = {"phase": "bench_exact", **rec, "launches": launches,
           "expected_launches": expected_launches(slam),
           "checkpoint": path, "checkpoint_s": ckpt_s,
           "resume_start": start, "bit_equal": same}
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
        from myslam_torch.tools.bench_sample_bwd import layouts
        from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    library = cuda_sample.build()
    ptxas = [ln.strip() for ln in cuda_sample.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln
             or "Function properties" in ln]
    spilled = spills(cuda_sample.BUILD_LOG)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": library, "ptxas": ptxas, "spills": spilled})
    if any("plane_sample_bwd" in fn for fn in spilled):
        raise AssertionError(f"K2 spills registers: {spilled}")

    cfg = load_config("configs/Synthetic/room.yaml", DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = N_FRAMES
    cases = check_kernels(cfg, layouts(cfg))
    slam = run_slam(cfg)
    bench = run_bench_scatter()
    run_bench_exact()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)

    # The kernels line: each kernel at the heaviest call of its path, the
    # mapping SDF sample (160,000 points) on bf16 quads (map_bf16 in
    # configs/Synthetic/room.yaml and in tracking).  K1/K2 launches are the
    # SLAM loop's, K3's the bench_scatter phase's.
    head = next(c for c in cases if c["layout"] == "sdf"
                and c["quad_dtype"] == "bfloat16" and "fwd" in c)
    # The records each kernel was checked in (K2: both point orders).
    checked = {"fwd": ("fwd",), "bwd": ("bwd", "bwd_rays"),
               "smem": ("smem",)}
    kernels = []
    for name, key, source, replaces, launches in (
            ("plane_sample_fwd", "fwd", "plane_sample.cu",
             "myslam_tpu/ops/pallas_sample.py:160",
             slam["launches"]["plane_sample_fwd"]),
            ("plane_sample_bwd", "bwd", "plane_sample.cu",
             "myslam_tpu/ops/plane_sample.py:343",
             slam["launches"]["plane_sample_bwd"]),
            ("plane_sample_fwd_smem", "smem", "plane_sample_smem.cu",
             "myslam_tpu/ops/pallas_sample.py:82 and :262",
             bench["launches"]["plane_sample_fwd_smem"])):
        rec = head[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"myslam_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c[k]["max_abs_err"] for c in cases
                               for k in checked[key] if k in c),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    # K2 on the loop's own ray-ordered points at the same sample.
    kernels[1]["ms_rays"] = head["bwd_rays"]["ms"]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
