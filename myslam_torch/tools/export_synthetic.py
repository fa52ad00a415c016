"""Export the synthetic analytic scene to real dataset layouts on disk.

The port of ``myslam_tpu/tools/export_synthetic.py``: the same files in
the layouts the readers consume (Replica: ``results/frame*.jpg`` +
``depth*.png`` + ``traj.txt``; ScanNet: ``color/``, ``depth/``,
``pose/``; TUM: ``rgb/`` + ``depth/`` + ``rgb.txt`` + ``depth.txt`` +
``groundtruth.txt``), written with the port's own codec
(``utils/imageio.py``), so that the disk -> reader -> loop path (JPEG
decode, u16 depth quantization, pose-column flips, TUM association and
first-pose rebasing) runs without a dataset download or an image
library, and against known poses and geometry.

Usage:
    python -m myslam_torch.tools.export_synthetic <config.yaml> \\
        --layout replica|scannet|tum --output DIR [--n-frames N] [--holes]
"""

from __future__ import annotations

import os

import numpy as np

from myslam_torch.utils import imageio
from myslam_torch.utils.datasets import Synthetic


def _unflip(c2w: np.ndarray) -> np.ndarray:
    """Negate rotation columns 1 and 2: the involution the readers apply,
    so that reader(unflip(p)) == p."""
    out = c2w.copy()
    out[:3, 1] *= -1
    out[:3, 2] *= -1
    return out


def _punch_hole(depth: np.ndarray, idx: int) -> np.ndarray:
    """A deterministic per-frame depth hole (a sensor dropout), so the
    loop's depth-less importance branch runs on data from disk."""
    H, W = depth.shape
    rng = np.random.default_rng(idx)
    ch = int(rng.integers(H // 4, H // 2))
    cw = int(rng.integers(W // 4, W // 2))
    depth = depth.copy()
    depth[ch:ch + H // 8, cw:cw + W // 6] = 0.0
    return depth


def _frame(ds: Synthetic, i: int, holes: bool):
    """Frame ``i`` as uint8 RGB, float depth (holes punched) and pose."""
    color, depth, pose = ds.get_frame(i)
    if holes:
        depth = _punch_hole(depth, i)
    return (np.clip(color, 0, 1) * 255).astype(np.uint8), depth, pose


def _depth_u16(depth: np.ndarray, png_depth_scale: float) -> np.ndarray:
    return np.clip(depth * png_depth_scale, 0, 65535).astype(np.uint16)


def export_replica(cfg: dict, out_dir: str, n_frames: int | None = None,
                   png_depth_scale: float = 6553.5,
                   holes: bool = False) -> None:
    """Replica layout: results/frame%06d.jpg (quality 98),
    results/depth%06d.png, traj.txt (flattened c2w rows, reader flip
    pre-applied)."""
    ds = Synthetic(cfg)
    n = min(n_frames or len(ds), len(ds))
    res = os.path.join(out_dir, "results")
    os.makedirs(res, exist_ok=True)
    lines = []
    for i in range(n):
        rgb, depth, pose = _frame(ds, i, holes)
        imageio.write_jpeg(os.path.join(res, f"frame{i:06d}.jpg"), rgb, 98)
        imageio.write_png(os.path.join(res, f"depth{i:06d}.png"),
                          _depth_u16(depth, png_depth_scale))
        lines.append(" ".join(f"{v:.9f}" for v in _unflip(pose).reshape(-1)))
    with open(os.path.join(out_dir, "traj.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def export_scannet(cfg: dict, out_dir: str, n_frames: int | None = None,
                   png_depth_scale: float = 1000.0,
                   invalid_frames: tuple = (),
                   holes: bool = False) -> None:
    """ScanNet layout: color/{i}.jpg, depth/{i}.png, pose/{i}.txt (4x4
    text matrices, reader flip pre-applied, numeric-sort names).
    ``invalid_frames`` get -inf pose files, as real ScanNet's lost
    frames do; eval_ate masks them."""
    ds = Synthetic(cfg)
    n = min(n_frames or len(ds), len(ds))
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    for i in range(n):
        rgb, depth, pose = _frame(ds, i, holes)
        imageio.write_jpeg(os.path.join(out_dir, "color", f"{i}.jpg"), rgb,
                           98)
        imageio.write_png(os.path.join(out_dir, "depth", f"{i}.png"),
                          _depth_u16(depth, png_depth_scale))
        p = (np.full((4, 4), -np.inf) if i in invalid_frames
             else _unflip(pose))
        np.savetxt(os.path.join(out_dir, "pose", f"{i}.txt"), p)


def export_tum(cfg: dict, out_dir: str, n_frames: int | None = None,
               png_depth_scale: float = 5000.0, fps: float = 30.0,
               holes: bool = True) -> None:
    """TUM layout: rgb/, depth/ (PNG), rgb.txt, depth.txt,
    groundtruth.txt.

    The reader rebases the first pose to the identity and flips the
    columns after rebasing, so the trajectory the loop sees lives in the
    frame ``A = flip(I) @ inv(unflip(p0))`` of the synthetic world;
    ``tum_world_transform(cfg)`` returns A, to move the scene's bound.
    """
    from scipy.spatial.transform import Rotation

    ds = Synthetic(cfg)
    n = min(n_frames or len(ds), len(ds))
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(n):
        t = i / fps
        rgb, depth, pose = _frame(ds, i, holes)
        imageio.write_png(os.path.join(out_dir, "rgb", f"{t:.6f}.png"), rgb)
        imageio.write_png(os.path.join(out_dir, "depth", f"{t:.6f}.png"),
                          _depth_u16(depth, png_depth_scale))
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t:.6f} depth/{t:.6f}.png")
        q = _unflip(pose)
        quat = Rotation.from_matrix(q[:3, :3]).as_quat()  # x, y, z, w
        gt_lines.append(
            f"{t:.6f} " + " ".join(f"{v:.9f}" for v in q[:3, 3])
            + " " + " ".join(f"{v:.9f}" for v in quat))
    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.write("\n".join(rgb_lines) + "\n")
    with open(os.path.join(out_dir, "depth.txt"), "w") as f:
        f.write("\n".join(depth_lines) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        f.write("\n".join(gt_lines) + "\n")


def tum_world_transform(cfg: dict) -> np.ndarray:
    """Rigid A with loop_pose_i = A @ synthetic_pose_i for a TUM export
    (the reader's first-pose rebase, then the column flip)."""
    p0 = Synthetic(cfg).poses[0].astype(np.float64)
    flip_eye = np.diag([1.0, -1.0, -1.0, 1.0])
    return flip_eye @ np.linalg.inv(_unflip(p0))


def transform_bound(bound, A: np.ndarray, pad: float = 0.1) -> list:
    """AABB of a transformed AABB's corners (+pad), as [[lo, hi], ...]."""
    bound = np.asarray(bound, np.float64)
    corners = np.stack(np.meshgrid(*bound, indexing="ij"),
                       axis=-1).reshape(-1, 3)
    tc = corners @ A[:3, :3].T + A[:3, 3]
    lo = tc.min(axis=0) - pad
    hi = tc.max(axis=0) + pad
    return [[float(a), float(b)] for a, b in zip(lo, hi)]


def main(argv=None):
    import argparse

    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--layout", choices=("replica", "scannet", "tum"),
                    default="replica")
    ap.add_argument("--output", required=True)
    ap.add_argument("--n-frames", type=int, default=None)
    ap.add_argument("--holes", action="store_true")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, DEFAULT_CONFIG)
    if args.layout == "replica":
        export_replica(cfg, args.output, args.n_frames, holes=args.holes)
    elif args.layout == "scannet":
        export_scannet(cfg, args.output, args.n_frames, holes=args.holes)
    else:
        export_tum(cfg, args.output, args.n_frames, holes=True)
    print(f"exported {args.layout} layout to {args.output}")


if __name__ == "__main__":
    main()
