"""Ray generation, AABB intersection, coordinate normalization, projection.

Camera convention: right-handed, camera looks along -z, y flipped
(dirs = [(i-cx)/fx, -(j-cy)/fy, -1]), as in the reference ESLAM and in
``myslam_tpu.core.geometry``.
"""

from __future__ import annotations

import torch


def _apply_rot(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3) @ v (..., 3), broadcasting the batch dimensions."""
    return torch.matmul(R, v.unsqueeze(-1)).squeeze(-1)


def pixel_dirs(i: torch.Tensor, j: torch.Tensor, fx, fy, cx, cy):
    """Camera-frame ray directions for pixel coords (i=column, j=row)."""
    return torch.stack(
        [(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], dim=-1)


def rays_from_uv(i, j, c2w: torch.Tensor, fx, fy, cx, cy):
    """World-frame rays (rays_o, rays_d), each (..., 3), for pixel coords
    under pose(s) c2w (..., 4, 4), broadcastable with i."""
    dirs = pixel_dirs(i, j, fx, fy, cx, cy)
    rays_d = _apply_rot(c2w[..., :3, :3], dirs)
    rays_o = c2w[..., :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def rays_full_image(H: int, W: int, fx, fy, cx, cy, c2w: torch.Tensor):
    """Rays (rays_o, rays_d), each (H, W, 3), for every pixel of an H x W
    image under pose c2w (4, 4)."""
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=c2w.device),
        torch.arange(W, dtype=torch.float32, device=c2w.device),
        indexing="ij")
    return rays_from_uv(i, j, c2w, fx, fy, cx, cy)


def normalize_3d_coordinate(p: torch.Tensor, bound: torch.Tensor):
    """World points (..., 3) into [-1, 1]^3 against bound (3, 2)."""
    lo = bound[:, 0]
    hi = bound[:, 1]
    return (p - lo) / (hi - lo) * 2.0 - 1.0


def ray_aabb_exit_t(rays_o, rays_d, bound: torch.Tensor) -> torch.Tensor:
    """Per ray (N,), the t of its last axis-plane crossing of the AABB:
    min over axes of max over {lo, hi} of (bound - o) / d."""
    t = (bound[None, :, :] - rays_o[:, :, None]) / rays_d[:, :, None]
    return t.amax(dim=2).amin(dim=1)


def project_points(pts, w2c, fx, fy, cx, cy):
    """World points (..., 3) into camera(s) w2c (..., 4, 4).

    Returns (u, v, z_cam); z_cam < 0 in front of the camera.  The x flip
    of the camera frame comes before the pinhole projection.
    """
    cam = _apply_rot(w2c[..., :3, :3], pts) + w2c[..., :3, 3]
    x = -cam[..., 0]
    y = cam[..., 1]
    z = cam[..., 2]
    zs = z + 1e-5
    u = (fx * x + cx * z) / zs
    v = (fy * y + cy * z) / zs
    return u, v, z


def invert_pose(c2w: torch.Tensor) -> torch.Tensor:
    """Invert rigid transforms (..., 4, 4) analytically."""
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_new = -_apply_rot(Rt, t)
    top = torch.cat([Rt, t_new[..., None]], dim=-1)
    bottom = c2w.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        c2w.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)
