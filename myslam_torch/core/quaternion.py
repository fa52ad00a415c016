"""Quaternion <-> rotation-matrix conversions and 7-dof camera poses.

pytorch3d conventions, as the reference and ``myslam_tpu`` keep them:
quaternions are (w, x, y, z); ``quaternion_to_matrix`` rescales by
2/|q|^2, so a non-unit quaternion (mid-optimization) still gives a proper
rotation; a camera pose is the 7-vector [qw, qx, qy, qz, tx, ty, tz].
"""

from __future__ import annotations

import torch


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = quat.unbind(-1)
    two_s = 2.0 / (quat * quat).sum(-1)
    o = torch.stack(
        [
            1 - two_s * (y * y + z * z),
            two_s * (x * y - z * w),
            two_s * (x * z + y * w),
            two_s * (x * y + z * w),
            1 - two_s * (x * x + z * z),
            two_s * (y * z - x * w),
            two_s * (x * z - y * w),
            two_s * (y * z + x * w),
            1 - two_s * (x * x + y * y),
        ],
        dim=-1,
    )
    return o.reshape(quat.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion.

    Shepperd's method: the four candidate parameterizations, of which the
    numerically dominant one is picked (pytorch3d's choice).  Used only
    outside gradient paths (pose bookkeeping).
    """
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    m01, m02 = m[..., 0, 1], m[..., 0, 2]
    m10, m12 = m[..., 1, 0], m[..., 1, 2]
    m20, m21 = m[..., 2, 0], m[..., 2, 1]
    q_abs_sq = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp(q_abs_sq, min=0.0))
    cand_w = torch.stack(
        [q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cand_x = torch.stack(
        [m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1)
    cand_y = torch.stack(
        [m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1)
    cand_z = torch.stack(
        [m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    cands = cands / (2.0 * torch.clamp(q_abs, min=1e-8))[..., None]
    best = q_abs_sq.argmax(dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return torch.gather(cands, -2, idx).squeeze(-2)


def matrix_to_cam_pose(c2w: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 7) [quat(wxyz), t]."""
    return torch.cat(
        [matrix_to_quaternion(c2w[..., :3, :3]), c2w[..., :3, 3]], dim=-1)


def cam_pose_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """(..., 7) [quat, t] -> (..., 4, 4)."""
    rot = quaternion_to_matrix(pose[..., :4])
    # The [0, 0, 0, 1] row filled on the pose's device, with no copy from
    # the host (the tracker captures this into a CUDA graph).
    bottom = pose.new_zeros(pose.shape[:-1] + (1, 4))
    bottom[..., 3] = 1.0
    top = torch.cat([rot, pose[..., 4:, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)
