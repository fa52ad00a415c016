"""Absolute trajectory error (ATE): Horn's closed-form alignment of the
estimated to the ground-truth trajectory, then statistics of the
translational error; GT poses with nan/inf are masked out.

CLI (the newest checkpoint of a run):
    python -m myslam_torch.tools.eval_ate <config.yaml> [--output DIR]

The JAX package's ``--plot`` is not ported: it needs matplotlib.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray):
    """Align model (3, n) to data (3, n).  Returns rot (3, 3), trans
    (3, 1) and the per-point translational error (n,)."""
    model_zc = model - model.mean(1, keepdims=True)
    data_zc = data - data.mean(1, keepdims=True)
    W = model_zc @ data_zc.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    err = rot @ model + trans - data
    return rot, trans, np.sqrt((err * err).sum(0))


def evaluate_ate(gt_traj: np.ndarray, est_traj: np.ndarray) -> dict:
    """gt_traj, est_traj: (n, 4, 4) associated pose arrays."""
    _, _, err = horn_align(gt_traj[:, :3, 3].T, est_traj[:, :3, 3].T)
    return {
        "compared_pose_pairs": int(err.shape[0]),
        "absolute_translational_error.rmse": float(np.sqrt(np.mean(err ** 2))),
        "absolute_translational_error.mean": float(np.mean(err)),
        "absolute_translational_error.median": float(np.median(err)),
        "absolute_translational_error.std": float(np.std(err)),
        "absolute_translational_error.min": float(np.min(err)),
        "absolute_translational_error.max": float(np.max(err)),
    }


def convert_poses(c2w_list: np.ndarray, scale: float = 1.0):
    """Mask invalid (nan/inf) poses and undo the scene scale.  Returns
    (poses, mask)."""
    poses = c2w_list.copy().astype(np.float64)
    mask = np.ones(len(poses), bool)
    for i, p in enumerate(poses):
        if np.isinf(p).any() or np.isnan(p).any():
            mask[i] = False
        poses[i, :3, 3] /= scale
    return poses[mask], mask


def evaluate_run(estimates: np.ndarray, gt_poses: np.ndarray,
                 scale: float = 1.0) -> dict:
    gt, mask = convert_poses(gt_poses, scale)
    est, _ = convert_poses(estimates[mask], scale)
    return evaluate_ate(gt, est)


def main(argv=None) -> dict:
    """Print the ATE of the newest checkpoint under ``<output>/ckpts``
    as ``key: value`` lines, as the JAX package's CLI does."""
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
    from myslam_torch.utils.logger import latest_checkpoint

    parser = argparse.ArgumentParser(description="Evaluate ATE of a run.")
    parser.add_argument("config", type=str)
    parser.add_argument("--output", type=str, default=None)
    args = parser.parse_args(argv)

    cfg = load_config(args.config, DEFAULT_CONFIG)
    output = args.output or cfg["data"]["output"]
    ckpt = latest_checkpoint(os.path.join(output, "ckpts"))
    if ckpt is None:
        raise SystemExit(f"no checkpoints under {output}/ckpts")
    with np.load(ckpt, allow_pickle=True) as data:
        n = int(data["idx"]) + 1
        result = evaluate_run(
            data["estimate_c2w_list"][:n], data["gt_c2w_list"][:n],
            scale=cfg.get("scale", 1))
    for k, v in result.items():
        print(f"{k}: {v}")
    return result


if __name__ == "__main__":
    main()
