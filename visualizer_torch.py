#!/usr/bin/env python
"""Offline trajectory and mesh replay of a run, with the PyTorch port.

    python visualizer_torch.py <config> [--output DIR] [--top_view]
        [--save_rendering] [--every N] [--interactive] [--device cpu]

The counterpart of ``visualizer.py``: the newest checkpoint of the run
gives the estimated (red) and ground-truth (green) trajectories; each
per-frame culled mesh (``<output>/mesh/*_culled.ply``) becomes the
background once the replay reaches the frame that produced it, rendered
as gray depth (farther is darker) by the port's z-buffer rasterizer
(``utils/meshmath.make_depth_rasterizer``, on the GPU unless ``--device
cpu``) from one fixed camera framed on the last mesh.  Frames are 600 x
600 JPEGs, ``<output>/vis/{i:05d}.jpg``, drawn in numpy and encoded with
the port's codec (no plotting library, no titles); ``--save_rendering``
also encodes ``vis/replay.mp4`` when ffmpeg exists.  ``--interactive``
feeds the poses and meshes to ``myslam_torch.utils.frontend``.
"""

import argparse
import glob
import os
import re
import subprocess

import numpy as np

# Replay frame size and the fixed camera's focal length, in pixels.
H = W = 600
FOCAL = 500.0
# Meshes are subdivided to this edge (meters) before rasterizing.
EDGE = 0.05


def _mesh_schedule(output: str, n: int):
    """[(first frame at which to show it, path)] for every culled mesh of
    the run, ascending; the final mesh belongs to the last frame."""
    sched = []
    for p in glob.glob(os.path.join(output, "mesh", "*_culled.ply")):
        m = re.match(r"^(\d+)_", os.path.basename(p))
        sched.append((int(m.group(1)) if m else n - 1, p))
    return sorted(sched)


def mesh_at(schedule, i: int):
    """The newest scheduled mesh at or before frame i, or None."""
    current = None
    for at, path in schedule:
        if at <= i:
            current = path
    return current


def mesh_view(verts: np.ndarray, top_view: bool = False) -> np.ndarray:
    """The fixed replay camera (w2c, 4 x 4, +z forward) framed on a mesh:
    from above, or from the front and above."""
    center = verts.mean(0)
    extent = (verts.max(0) - verts.min(0)).max()
    if top_view:
        eye = center + np.array([0.0, 0.0, 1.8 * extent])
        fwd = np.array([0.0, 0.0, -1.0])
        right = np.array([1.0, 0.0, 0.0])
    else:
        eye = center + np.array([0.0, -1.4 * extent, 0.9 * extent])
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, down, fwd], 1)
    c2w[:3, 3] = eye
    return np.linalg.inv(c2w)


def mesh_depth(path: str, w2c: np.ndarray, render) -> np.ndarray:
    """Depth (H, W) of the mesh at ``path`` from w2c, 0 where empty."""
    from myslam_torch.utils.meshmath import subdivide_to_edge
    from myslam_torch.utils.ply import read_ply

    v, f, _ = read_ply(path)
    v, f = subdivide_to_edge(v, f, EDGE)
    return render(v[f], w2c)


def gray_background(depth: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8: white where empty; where the mesh is, gray from
    255 (nearest) to 77 (farthest): a reversed gray ramp at 0.7 opacity
    over white."""
    img = np.full(depth.shape + (3,), 255, np.uint8)
    hit = depth > 0
    if hit.any():
        d = depth[hit]
        t = (d - d.min()) / max(float(d.max() - d.min()), 1e-9)
        level = 255.0 * (1.0 - 0.7 * t)
        img[hit] = np.rint(level).astype(np.uint8)[:, None]
    return img


def _load_run(output: str):
    """The run's estimated and ground-truth poses (n, 4, 4) from its
    newest checkpoint, and its mesh schedule."""
    from myslam_torch.utils.logger import latest_checkpoint

    ckpt = latest_checkpoint(os.path.join(output, "ckpts"))
    if ckpt is None:
        raise SystemExit(f"no checkpoints under {output}/ckpts")
    data = np.load(ckpt, allow_pickle=True)
    n = int(data["idx"]) + 1
    return (data["estimate_c2w_list"][:n], data["gt_c2w_list"][:n],
            _mesh_schedule(output, n))


def replay(output: str, top_view: bool = False,
           save_rendering: bool = False, every: int = 10,
           device=None) -> list:
    """Render the replay frames; returns the written image paths."""
    from myslam_torch.utils.draw import GREEN, RED, draw_dot, \
        draw_polyline, fit_view
    from myslam_torch.utils.imageio import write_jpeg
    from myslam_torch.utils.meshmath import make_depth_rasterizer
    from myslam_torch.utils.ply import read_ply

    est, gt, meshes = _load_run(output)
    n = len(est)
    if meshes:
        verts, _, _ = read_ply(meshes[-1][1])
        w2c = mesh_view(verts, top_view)
        render = make_depth_rasterizer(H, W, FOCAL, FOCAL, W / 2, H / 2,
                                       device=device)

        def project(pts):
            cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
            return (FOCAL * cam[:, 0] / cam[:, 2] + W / 2,
                    FOCAL * cam[:, 1] / cam[:, 2] + H / 2)
    else:
        fitted = fit_view(np.concatenate([est, gt])[:, :2, 3], H, W)

        def project(pts):
            return fitted(pts[:, :2])

    backgrounds: dict = {}
    vis_dir = os.path.join(output, "vis")
    os.makedirs(vis_dir, exist_ok=True)
    frames = []
    for i in range(0, n, max(every, 1)):
        path = mesh_at(meshes, i)
        if path is None:
            img = np.full((H, W, 3), 255, np.uint8)
        else:
            if path not in backgrounds:
                backgrounds[path] = gray_background(
                    mesh_depth(path, w2c, render))
            img = backgrounds[path].copy()
        draw_polyline(img, *project(gt[:i + 1, :3, 3]), GREEN)
        ex, ey = project(est[:i + 1, :3, 3])
        draw_polyline(img, ex, ey, RED)
        draw_dot(img, ex[-1], ey[-1], RED)
        out = os.path.join(vis_dir, f"{i:05d}.jpg")
        write_jpeg(out, img)
        frames.append(out)

    print(f"Wrote {len(frames)} frames to {vis_dir} "
          f"({len(backgrounds)} mesh swaps)")
    if save_rendering and frames:
        mp4 = os.path.join(vis_dir, "replay.mp4")
        try:
            subprocess.run(
                ["ffmpeg", "-y", "-framerate", "10", "-pattern_type", "glob",
                 "-i", os.path.join(vis_dir, "[0-9]*.jpg"), "-c:v",
                 "libx264", "-pix_fmt", "yuv420p", mp4],
                check=True, capture_output=True)
            print(f"Wrote {mp4}")
        except (FileNotFoundError, subprocess.CalledProcessError) as e:
            print(f"ffmpeg unavailable or failed ({e}); frames kept as "
                  "jpgs")
    return frames


def replay_interactive(output: str, save_rendering: bool = False,
                       every: int = 1, backend: str = "auto"):
    """Feed the run's poses and mesh schedule to the frontend
    (``myslam_torch.utils.frontend``); without a display it records
    headless top views.  Returns the joined frontend."""
    from myslam_torch.utils.frontend import SLAMFrontend

    est, gt, meshes = _load_run(output)
    n = len(est)

    frontend = SLAMFrontend(output, save_rendering=save_rendering,
                            backend=backend).start()
    print(f"frontend backend: {frontend.backend}")
    mi = 0
    for i in range(0, n, max(every, 1)):
        while mi < len(meshes) and meshes[mi][0] <= i:
            frontend.update_mesh(meshes[mi][1])
            mi += 1
        frontend.update_pose(i, est[i], gt[i])
    frontend.join()
    return frontend


def main(argv=None):
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    parser = argparse.ArgumentParser(description="Replay a SLAM run.")
    parser.add_argument("config", type=str)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--top_view", action="store_true")
    parser.add_argument("--save_rendering", action="store_true",
                        help="also encode vis/replay.mp4 when ffmpeg exists")
    parser.add_argument("--every", type=int, default=10,
                        help="render every Nth frame")
    parser.add_argument("--interactive", action="store_true",
                        help="live replay (open3d or matplotlib window when "
                        "a display exists; headless recorder otherwise)")
    parser.add_argument("--device", default=None,
                        help="the rasterizer's device (default: the GPU)")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, DEFAULT_CONFIG)
    output = args.output or cfg["data"]["output"]
    if args.interactive:
        replay_interactive(output, save_rendering=args.save_rendering,
                           every=args.every)
        return
    replay(output, top_view=args.top_view,
           save_rendering=args.save_rendering, every=args.every,
           device=args.device)


if __name__ == "__main__":
    main()
