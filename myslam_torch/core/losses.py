"""Masked SLAM losses: SDF free-space/center/tail, color, depth.

Every loss is a masked sum over a masked count, which equals the
reference's plain mean over the boolean-filtered subset.
"""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over elements where mask is True; 0 if mask is empty."""
    m = mask.to(x.dtype)
    cnt = m.sum()
    return (x * m).sum() / torch.clamp(cnt, min=1.0)


def sdf_losses(sdf, z_vals, gt_depth, ray_mask, truncation: float,
               w_fs: float, w_center: float, w_tail: float) -> torch.Tensor:
    """Weighted free-space + center + tail SDF losses.

    sdf, z_vals: (R, N); gt_depth, ray_mask: (R,).  Each ray's samples
    split by z against its depth: front (z < d - trunc) pushes sdf to +1;
    center (|z - d| < 0.4 trunc) and the remaining tail band pull
    z + sdf*trunc to d.
    """
    d = gt_depth[:, None]
    rm = ray_mask[:, None]
    front = (z_vals < d - truncation) & rm
    back = (z_vals > d + truncation) & rm
    center = ((z_vals > d - 0.4 * truncation)
              & (z_vals < d + 0.4 * truncation) & rm)
    tail = (~front) & (~back) & (~center) & rm
    fs_loss = masked_mean(torch.square(sdf - 1.0), front)
    est = z_vals + sdf * truncation
    center_loss = masked_mean(torch.square(est - d), center)
    tail_loss = masked_mean(torch.square(est - d), tail)
    return w_fs * fs_loss + w_center * center_loss + w_tail * tail_loss


def color_loss(gt_color, color, ray_mask):
    """Masked mean squared color error; gt/color (R, 3), mask (R,)."""
    sq = torch.square(gt_color - color)
    return masked_mean(sq, ray_mask[:, None].expand(sq.shape))


def depth_loss(gt_depth, depth, ray_mask):
    """Masked mean squared depth error; (R,) each."""
    return masked_mean(torch.square(gt_depth - depth), ray_mask)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x over mask with the lower-middle convention: for n
    masked values, sorted[(n-1)//2].  An empty mask gives +inf (which
    then empties the masks derived from it).  No host sync."""
    n = mask.sum()
    vals = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))))
    idx = torch.clamp(n - 1, min=0) // 2
    # gather, not vals[idx]: indexing by a 0-dim tensor reads it on the host.
    return vals.values.gather(0, idx.reshape(1))[0]
