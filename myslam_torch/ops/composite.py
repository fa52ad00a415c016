"""SDF -> alpha -> transmittance compositing along rays.

    alpha = 1 - exp(-beta * sigmoid(-beta * sdf))
    w_i   = alpha_i * prod_{j<i} (1 - alpha_j + 1e-10)
    depth = sum w_i z_i ; rgb = sum w_i c_i
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable


class CumprodPositive(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of an input with no zero
    element.  The backward is PyTorch's own for that case (the reversed
    cumulative sum of output x gradient, over the input) without PyTorch's
    test for zeros, which reads a flag back to the host and so stops a
    CUDA graph's capture; the gradients are the same bits."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        if x.shape[-1] == 1:
            return grad
        return (out * grad).flip(-1).cumsum(-1).flip(-1) / x


def sdf2alpha(sdf: torch.Tensor, beta) -> torch.Tensor:
    return 1.0 - torch.exp(-beta * torch.sigmoid(-sdf * beta))


def composite_weights(alpha: torch.Tensor) -> torch.Tensor:
    """Rendering weights (..., N): alpha times the exclusive cumulative
    product of (1 - alpha + 1e-10) along the sample axis (alpha <= 1, so
    no factor is zero)."""
    trans = CumprodPositive.apply(1.0 - alpha + 1e-10)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    return alpha * trans


def composite(alpha, z_vals, rgb):
    """Depth and color; alpha, z_vals (R, N), rgb (R, N, 3)."""
    w = composite_weights(alpha)
    depth = (w * z_vals).sum(-1)
    color = (w[..., None] * rgb).sum(-2)
    return depth, color, w


def composite_topk(alpha, z_vals, pts, rgb_at, k: int):
    """Top-K color compositing.

    Depth composites over all samples; color is queried (``rgb_at``:
    (M, 3) world points -> (M, 3) rgb) only at the K highest-weight
    samples per ray, selected on the detached weights.  alpha, z_vals
    (..., N); pts (..., N, 3).  Returns (depth, color).
    """
    w = composite_weights(alpha)
    top_idx = torch.topk(w.detach(), k, dim=-1).indices
    pts_k = torch.gather(pts, -2, top_idx[..., None].expand(
        top_idx.shape + (3,)))
    rgb_k = rgb_at(pts_k.reshape(-1, 3)).reshape(top_idx.shape + (3,))
    w_k = torch.gather(w, -1, top_idx)
    depth = (w * z_vals).sum(-1)
    color = (w_k[..., None] * rgb_k).sum(-2)
    return depth, color
