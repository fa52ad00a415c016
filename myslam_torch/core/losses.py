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
    (fs, front), (sq_c, center), (sq_t, tail) = sdf_terms(
        sdf, z_vals, gt_depth, ray_mask, truncation)
    fs_loss = masked_mean(fs, front)
    center_loss = masked_mean(sq_c, center)
    tail_loss = masked_mean(sq_t, tail)
    return w_fs * fs_loss + w_center * center_loss + w_tail * tail_loss


def sdf_terms(sdf, z_vals, gt_depth, ray_mask, truncation: float) -> list:
    """sdf_losses' three terms as (values, mask) pairs: free space,
    center, tail."""
    d = gt_depth[:, None]
    rm = ray_mask[:, None]
    front = (z_vals < d - truncation) & rm
    back = (z_vals > d + truncation) & rm
    center = ((z_vals > d - 0.4 * truncation)
              & (z_vals < d + 0.4 * truncation) & rm)
    tail = (~front) & (~back) & (~center) & rm
    est = z_vals + sdf * truncation
    return [(torch.square(sdf - 1.0), front),
            (torch.square(est - d), center), (torch.square(est - d), tail)]


def slam_terms(sdf, z_vals, gt_depth, sdf_mask, truncation: float,
               gt_color, color, color_mask, depth, depth_mask) -> list:
    """The five (values, mask) pairs of the SLAM loss, in the order of
    its weights (free space, center, tail, color, depth)."""
    sq = torch.square(gt_color - color)
    return sdf_terms(sdf, z_vals, gt_depth, sdf_mask, truncation) + [
        (sq, color_mask[:, None].expand(sq.shape)),
        (torch.square(gt_depth - depth), depth_mask)]


def global_weighted_loss(terms: list, weights, all_reduce_) -> torch.Tensor:
    """Σ_k w_k · (masked mean of term k over every rank's rays).

    Each rank sums its own (values, mask) pairs; their sums and counts
    cross the ranks in one ``all_reduce_`` (summing a 1-D tensor in
    place), so every rank sees the same global means, and the
    gradient of the result with respect to this rank's values is that of
    the global loss: summing the ranks' gradients gives the exact global
    gradient.  The weighted sum runs in sdf_losses' order, then color,
    then depth."""
    masks = [m.to(x.dtype) for x, m in terms]
    s = torch.stack([(x * m).sum() for (x, _), m in zip(terms, masks)])
    c = torch.stack([m.sum() for m in masks])
    k = len(terms)
    tot = all_reduce_(torch.cat([s.detach(), c]))
    means = (tot[:k] + (s - s.detach())) / torch.clamp(tot[k:], min=1.0)
    loss = (weights[0] * means[0] + weights[1] * means[1]
            + weights[2] * means[2])
    for w, mean in zip(weights[3:], means[3:]):
        loss = loss + w * mean
    return loss


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
