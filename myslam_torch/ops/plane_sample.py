"""Fused tri-plane bilinear sampling from a feature atlas.

The semantics are those of the reference's per-plane ``F.grid_sample(...,
mode='bilinear', padding_mode='border', align_corners=True)`` followed by
the per-level sum over the three orientations:

  * align_corners=True: pixel coord = (coord + 1) / 2 * (size - 1);
  * border padding: coords clamped to [0, size - 1], which also zeroes
    the coordinate gradient outside the border.

Two stages, as in ``myslam_tpu.ops.plane_sample``:

  1. ``pack_quad`` rewrites the (S, C) atlas into the (S, 4C) quad atlas
     whose row r holds the 2x2 neighbourhood [A[y,x] | A[y,x+1] |
     A[y+1,x] | A[y+1,x+1]] (edges clamped).  Plain slicing and
     concatenation, so autograd gives its backward.
  2. ``sample_fused`` reads one quad row per (point, plane) and returns
     the weighted, orientation-summed corner features (N, L*4C).  The
     decoders fold the remaining corner/level sum into their first
     matmul through ``reduced_row_map``.

``SampleFused`` is the autograd Function: kernels K1/K2 on CUDA tensors,
the plain versions on CPU tensors (``ops/cuda_sample.py``).
``SampleBanded`` is its counterpart over one map shard's band atlas
(``parallel/plane_shard.py``): banded K1/K2, this shard's terms alone.
"""

from __future__ import annotations

import numpy as np
import torch

from myslam_torch.models.planes import BandLayout, PlaneLayout
from myslam_torch.ops import cuda_sample

# The plain forward, under the name the renderer's tests use.
sample_quad_reduced_ref = cuda_sample.plane_sample_fwd_ref


def pack_quad(atlas: torch.Tensor, layout: PlaneLayout) -> torch.Tensor:
    """(S, C) atlas -> (S, 4C) quad atlas of 2x2 corner neighbourhoods."""
    parts = []
    C = atlas.shape[-1]
    for _, _, _, _, H, W, off in layout.planes():
        a = atlas[off:off + H * W].reshape(H, W, C)
        right = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
        down = torch.cat([a[1:], a[-1:]], dim=0)
        down_right = torch.cat([down[:, 1:], down[:, -1:]], dim=1)
        q = torch.cat([a, right, down, down_right], dim=-1)
        parts.append(q.reshape(H * W, 4 * C))
    return torch.cat(parts, dim=0)


def reduced_row_map(layout: PlaneLayout) -> np.ndarray:
    """Map from orientation-summed corner rows (L*4C) to feature rows
    (L*C): row (l, corner, k) -> l*C + k.  For any (D, L*C) weight W,
    F.linear(corners, W[:, row_map]) == F.linear(reduced features, W)."""
    C = layout.c_dim
    r = np.arange(layout.n_levels * 4 * C)
    return (r // (4 * C)) * C + (r % C)


class SampleFused(torch.autograd.Function):
    """Tri-plane sample with a hand-written backward.

    Forward: kernel K1 (CUDA) or the plain forward (CPU).  Backward:
    kernel K2 or the plain backward.  The quad gradient is computed only
    when autograd asks for it (tracking's quads are frozen, so there K2
    computes the coordinate gradient alone), and it is rounded to the
    quad's dtype, as the JAX VJP does.
    """

    @staticmethod
    def forward(ctx, quad, p_nor, layout):
        ctx.layout = layout
        ctx.save_for_backward(quad, p_nor)
        return cuda_sample.plane_sample_fwd(quad, layout, p_nor)

    @staticmethod
    def backward(ctx, gbar):
        quad, p_nor = ctx.saved_tensors
        need_quad = ctx.needs_input_grad[0]
        quad_grad, p_grad = cuda_sample.plane_sample_bwd(
            gbar.contiguous(), quad, ctx.layout, p_nor,
            need_quad_grad=need_quad)
        if quad_grad is not None:
            quad_grad = quad_grad.to(quad.dtype)
        return (quad_grad, p_grad if ctx.needs_input_grad[1] else None,
                None)


def sample_fused(quad: torch.Tensor, layout: PlaneLayout,
                 p_nor: torch.Tensor) -> torch.Tensor:
    """Weighted, orientation-summed corner features (N, L*4C) of the quad
    atlas at normalized points p_nor (N, 3)."""
    return SampleFused.apply(quad, p_nor.contiguous(), layout)


class SampleBanded(torch.autograd.Function):
    """The sample over one shard's band atlas with a hand-written
    backward: banded K1 / K2 (CUDA) or their plain versions (CPU).  The
    output and the coordinate gradient are this shard's parts (points
    outside a plane's band add nothing); the quad gradient has the band
    atlas's rows and is rounded to the quad's dtype, as SampleFused's."""

    @staticmethod
    def forward(ctx, quad, p_nor, band):
        ctx.band = band
        ctx.save_for_backward(quad, p_nor)
        return cuda_sample.plane_sample_fwd_banded(quad, band, p_nor)

    @staticmethod
    def backward(ctx, gbar):
        quad, p_nor = ctx.saved_tensors
        quad_grad, p_grad = cuda_sample.plane_sample_bwd_banded(
            gbar.contiguous(), quad, ctx.band, p_nor,
            need_quad_grad=ctx.needs_input_grad[0])
        if quad_grad is not None:
            quad_grad = quad_grad.to(quad.dtype)
        return (quad_grad, p_grad if ctx.needs_input_grad[1] else None,
                None)


def sample_banded(quad: torch.Tensor, band: BandLayout,
                  p_nor: torch.Tensor) -> torch.Tensor:
    """This shard's part (N, L*4C) of the sample of the band quad atlas
    ``quad`` at normalized points p_nor (N, 3)."""
    return SampleBanded.apply(quad, p_nor.contiguous(), band)
