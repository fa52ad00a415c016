#!/usr/bin/env python
"""Reconstruction evaluation: 3-D accuracy/completion + 2-D depth L1.

The port of ``myslam_tpu/tools/eval_recon.py`` (reference
src/tools/eval_recon.py, without the Open3D/trimesh dependencies):

  * 3-D: 450k area-weighted surface samples per mesh; accuracy = mean
    rec->GT KDTree distance (cm), completion = mean GT->rec (cm),
    completion ratio = GT samples within 5 cm (%)  (eval_recon.py:21-39).
  * Alignment: point-to-point ICP of mesh vertices, threshold 0.1
    (eval_recon.py:42-56), implemented with scipy cKDTree + Horn steps.
  * 2-D: mean |depth| difference over 1000 random 500x500 interior views
    rendered with a z-buffer rasterizer on a device (default: the
    GPU); views that would see the GT
    "unseen" point set are rejection-sampled when a *_pc_unseen.npy file
    exists next to the GT mesh (eval_recon.py:127-207).

CLI: python -m myslam_torch.tools.eval_recon --rec_mesh R --gt_mesh G -2d -3d
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

import numpy as np
from scipy.spatial import cKDTree as KDTree

import torch

from myslam_torch import resolve_device
from myslam_torch.utils.meshmath import (
    make_depth_rasterizer,
    oriented_bounds,
    sample_surface,
    subdivide_to_edge,
)
from myslam_torch.utils.ply import read_ply


def accuracy(gt_points, rec_points):
    return KDTree(gt_points).query(rec_points)[0].mean()


def completion(gt_points, rec_points):
    return KDTree(rec_points).query(gt_points)[0].mean()


def completion_ratio(gt_points, rec_points, dist_th=0.05):
    d = KDTree(rec_points).query(gt_points)[0]
    return (d < dist_th).mean()


def icp_p2p(src: np.ndarray, dst: np.ndarray, threshold: float = 0.1,
            iters: int = 30) -> np.ndarray:
    """Point-to-point ICP; returns 4x4 transform aligning src to dst."""
    tree = KDTree(dst)
    T = np.eye(4)
    cur = src.copy()
    prev_err = np.inf
    for _ in range(iters):
        d, j = tree.query(cur, distance_upper_bound=threshold)
        m = np.isfinite(d)
        if m.sum() < 10:
            break
        a = cur[m]
        b = dst[j[m]]
        ca, cb = a.mean(0), b.mean(0)
        H = (a - ca).T @ (b - cb)
        U, _, Vt = np.linalg.svd(H)
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R = Vt.T @ S @ U.T
        t = cb - R @ ca
        step = np.eye(4)
        step[:3, :3] = R
        step[:3, 3] = t
        T = step @ T
        cur = cur @ R.T + t
        err = d[m].mean()
        if abs(prev_err - err) < 1e-7:
            break
        prev_err = err
    return T


def calc_3d_metric(rec_meshfile: str, gt_meshfile: str, align: bool = True,
                   num_points: int = 450_000, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    rv, rf, _ = read_ply(rec_meshfile)
    gv, gf, _ = read_ply(gt_meshfile)
    if align:
        T = icp_p2p(rv, gv)
        rv = rv @ T[:3, :3].T + T[:3, 3]
    rec_pc = sample_surface(rv, rf, num_points, rng)
    gt_pc = sample_surface(gv, gf, num_points, rng)
    result = {
        "accuracy_cm": float(accuracy(gt_pc, rec_pc) * 100),
        "completion_cm": float(completion(gt_pc, rec_pc) * 100),
        "completion_ratio_pct": float(completion_ratio(gt_pc, rec_pc) * 100),
    }
    return result


def _viewmatrix(z, up, pos):
    """Reference eval_recon.py:13-19 (CV convention, +z forward)."""
    vec2 = z / np.linalg.norm(z)
    vec0 = np.cross(up, vec2)
    vec0 = vec0 / np.linalg.norm(vec0)
    vec1 = np.cross(vec2, vec0)
    vec1 = vec1 / np.linalg.norm(vec1)
    m = np.eye(4)
    m[:3, :4] = np.stack([vec0, vec1, vec2, pos], 1)
    return m


def _check_proj_sees(points, W, H, fx, fy, cx, cy, c2w):
    """Does this view see any of `points`? (reference eval_recon.py:60-86,
    including the y/z column flip into the SLAM camera convention)."""
    c = c2w.copy()
    c[:3, 1] *= -1
    c[:3, 2] *= -1
    w2c = np.linalg.inv(c)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    x = -cam[:, 0]
    z = cam[:, 2] + 1e-5
    u = (fx * x + cx * cam[:, 2]) / z
    v = (fy * cam[:, 1] + cy * cam[:, 2]) / z
    mask = (0 <= -z) & (u < W) & (u > 0) & (v < H) & (v > 0)
    return mask.sum() > 0


def _get_cam_position(gv: np.ndarray):
    """View-sampling volume: shrunken ORIENTED bounding box of the GT
    mesh + world-z lift, matching the reference protocol
    (eval_recon.py:116-124: oriented_bounds extents scaled by
    [0.3, 0.7, 0.7], transform[2, 3] += 0.4).  Returns (extents,
    box-to-world transform)."""
    to_origin, extents = oriented_bounds(gv)
    extents = extents.copy()
    extents[0] *= 0.3
    extents[1] *= 0.7
    extents[2] *= 0.7
    transform = np.linalg.inv(to_origin)
    transform[2, 3] += 0.4
    return extents, transform


def calc_2d_metric(rec_meshfile: str, gt_meshfile: str, n_imgs: int = 1000,
                   device=None) -> dict:
    H = W = 500
    fx = fy = 300.0
    cx = cy = H / 2.0 - 0.5
    rng = np.random.default_rng(0)

    rv, rf, _ = read_ply(rec_meshfile)
    gv, gf, _ = read_ply(gt_meshfile)
    unseen_file = re.sub(r"(_culled|_eval_rec)?\.ply$", "_pc_unseen.npy",
                         gt_meshfile)
    if os.path.exists(unseen_file):
        pc_unseen = np.load(unseen_file)
    else:
        pc_unseen = None
        # The reference rejection-samples views that would see the
        # "unseen" GT point set (eval_recon.py:156-175; the .npy ships
        # with its datasets, README.md:100-103).  Without it the
        # sampling is UNRESTRICTED — a different protocol whose numbers
        # are not comparable; say so loudly instead of degrading
        # silently.
        print(f"WARNING: {unseen_file} not found — 2-D views are "
              "sampled UNRESTRICTED (protocol differs from the "
              "reference's unseen-rejection sampling)", file=sys.stderr)
    T = icp_p2p(rv, gv)
    rv = rv @ T[:3, :3].T + T[:3, 3]

    # pre-subdivide so triangles fit the rasterizer's pixel patch
    rv, rf = subdivide_to_edge(rv, rf, 0.03)
    gv, gf = subdivide_to_edge(gv, gf, 0.03)
    render = make_depth_rasterizer(H, W, fx, fy, cx, cy,
                                   device=resolve_device(device))
    # Meshes upload once; each view's |gt - rec| mean accumulates on the
    # device and is read back once per 100 views.
    rec_dev = render.prep(rv[rf])
    gt_dev = render.prep(gv[gf])

    def view_err(w2c):
        gt_z = render.render_dev(gt_dev, w2c)
        rec_z = render.render_dev(rec_dev, w2c)
        gt_z = torch.where(torch.isfinite(gt_z), gt_z, 0.0)
        rec_z = torch.where(torch.isfinite(rec_z), rec_z, 0.0)
        return (gt_z - rec_z).abs().mean()

    ext, box2world = _get_cam_position(gv)
    up = np.array([0.0, 0.0, -1.0])
    err_sum = torch.zeros((), device=rec_dev.device)
    t0 = time.time()
    for v in range(n_imgs):
        for _attempt in range(100):
            o_box = rng.uniform(-0.5, 0.5, 3) * ext
            origin = box2world[:3, :3] @ o_box + box2world[:3, 3]
            target = rng.uniform(-10000, 10000, 3) - origin
            c2w = _viewmatrix(target, up, origin)
            if pc_unseen is None or not _check_proj_sees(
                    pc_unseen, W, H, fx, fy, cx, cy, c2w):
                break
        err_sum = err_sum + view_err(np.linalg.inv(c2w))
        if (v + 1) % 100 == 0:
            # One read-back per 100 views: progress of the ~2000-render
            # protocol at negligible cost.
            print(f"2-D views {v + 1}/{n_imgs} "
                  f"(running depth-L1 {float(err_sum) / (v + 1) * 100:.3f}"
                  f" cm, {time.time() - t0:.0f} s)", file=sys.stderr,
                  flush=True)
    return {"depth_l1_cm": float(err_sum) / n_imgs * 100}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate reconstruction quality.")
    parser.add_argument("--rec_mesh", type=str, required=True)
    parser.add_argument("--gt_mesh", type=str, required=True)
    parser.add_argument("-2d", "--metric_2d", action="store_true")
    parser.add_argument("-3d", "--metric_3d", action="store_true")
    parser.add_argument("--n_imgs", type=int, default=1000)
    parser.add_argument("--device", default=None,
                        help="torch device of the 2-D metric's rasterizer "
                        "(default: the GPU)")
    args = parser.parse_args(argv)

    if args.metric_3d:
        r = calc_3d_metric(args.rec_mesh, args.gt_mesh)
        print("accuracy: ", r["accuracy_cm"])
        print("completion: ", r["completion_cm"])
        print("completion ratio: ", r["completion_ratio_pct"])
    if args.metric_2d:
        r = calc_2d_metric(args.rec_mesh, args.gt_mesh, n_imgs=args.n_imgs,
                           device=args.device)
        print("Depth L1: ", r["depth_l1_cm"])


if __name__ == "__main__":
    main()
