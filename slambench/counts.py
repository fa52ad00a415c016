"""The yardstick's arithmetic: published peaks, the operations of a
tracking and a mapping iteration, and the least time the tri-plane
sample kernels can take.

The kernel counts are a frozen copy of ``chip_smoke.py``'s bound
arithmetic (``bound_ms``, ``bwd_bound`` and K1's count in
``check_fwd``): each input byte read once and each output byte written
once, the touched atlas rows counted from each call's own points.  A
later change that replaces a kernel is charged the same work.

The step's operations follow the algorithm, not the program's layout:
the sample as bilinear weights over 4 corners of 3 planes on each level,
the decoders on the reduced (levels x c_dim) features, compositing and
the losses per sample, and the backward as the sample's backward (the
kernel counts below) plus one (tracking: input gradients only) or two
(mapping: inputs and weights) matmul passes of the decoders.
"""

from __future__ import annotations

import torch

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
# at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

N_LEVELS = 2  # coarse and fine planes
HIDDEN = 16  # the decoders' width
N_BLOCKS = 2  # hidden layers per decoder
# f32 operations per sample for alpha, the weights' cumulative product,
# the depth and colour sums and the loss terms, forward; the backward
# counts twice that.
COMPOSITE_OPS = 40


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for the work on the card, and what sets it."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_FLOPS * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def fwd_work(n: int, c_dim: int, rows: int, elt: int) -> tuple[int, int]:
    """K1 on ``n`` points touching ``rows`` quad rows of ``elt``-byte
    elements: (bytes, f32 operations).  The points, the touched rows and
    the f32 output once each; a multiply and an add per (point, plane,
    lane)."""
    C4, L = 4 * c_dim, N_LEVELS
    nbytes = n * 3 * 4 + rows * C4 * elt + n * L * C4 * 4
    return nbytes, 2 * n * 3 * L * C4


def bwd_work(n: int, c_dim: int, rows: int, elt: int,
             quad_grad: bool) -> tuple[int, int]:
    """K2 on ``n`` points: (bytes, f32 operations).  gbar, the
    coordinates and p_grad once, the touched quad rows once, and with the
    quad gradient its touched rows written once; 7 (5 without the quad
    gradient) operations per (point, plane, lane)."""
    C4, L = 4 * c_dim, N_LEVELS
    nbytes = n * L * C4 * 4 + 2 * n * 3 * 4 + rows * C4 * (
        elt + (4 if quad_grad else 0))
    return nbytes, (7 if quad_grad else 5) * n * 3 * L * C4


def touched_rows(p_nor: torch.Tensor, planes) -> torch.Tensor:
    """Distinct atlas rows the points read, summed over the planes, as a
    0-dim device tensor (no host read).  ``planes``: (u-axis, v-axis, H,
    W) per plane; grid_sample's align_corners=True with the border
    clamp, as the kernels index."""
    total = torch.zeros((), dtype=torch.int64, device=p_nor.device)
    for au, av, H, W in planes:
        x = torch.clamp((p_nor[:, au] + 1.0) * 0.5 * (W - 1.0), 0.0, W - 1.0)
        y = torch.clamp((p_nor[:, av] + 1.0) * 0.5 * (H - 1.0), 0.0, H - 1.0)
        cell = (torch.floor(y) * W + torch.floor(x)).long()
        mark = torch.zeros((H * W,), dtype=torch.bool, device=p_nor.device)
        mark[cell] = True
        total = total + mark.sum()
    return total


def decoder_ops(c_dim: int, out: int) -> int:
    """Forward f32 operations of one decoder on one point."""
    dims = [N_LEVELS * c_dim] + [HIDDEN] * N_BLOCKS + [out]
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def sample_ops(c_dim: int) -> int:
    """Forward f32 operations of one field's sample on one point."""
    return 2 * 3 * N_LEVELS * 4 * c_dim


def point_ops(c_dim: int, grad: str) -> int:
    """f32 operations per sample point of one iteration: both fields'
    samples and decoders and the compositing, forward, then the backward
    (``grad``: "none", "inputs" (tracking: the pose's gradient) or
    "all" (mapping: the map's and the poses'))."""
    fwd = (2 * sample_ops(c_dim) + decoder_ops(c_dim, 1)
           + decoder_ops(c_dim, 3) + COMPOSITE_OPS)
    if grad == "none":
        return fwd
    dec = decoder_ops(c_dim, 1) + decoder_ops(c_dim, 3)
    C4, L = 4 * c_dim, N_LEVELS
    if grad == "inputs":
        bwd = 2 * 5 * 3 * L * C4 + dec + 2 * COMPOSITE_OPS
    else:
        bwd = 2 * 7 * 3 * L * C4 + 2 * dec + 2 * COMPOSITE_OPS
    return fwd + bwd


def iteration_ops(cfg: dict, kind: str, importance: bool = False) -> int:
    """f32 operations of one tracking (``kind`` "track") or mapping
    ("map") iteration at the config's shapes; a mapping iteration with
    ``importance`` adds the coarse SDF pass over the stratified samples
    (sample and decoder, no gradient)."""
    c_dim = int(cfg["model"]["c_dim"])
    r = cfg["rendering"]
    samples = int(r["n_stratified"]) + int(r["n_importance"])
    if kind == "track":
        n = int(cfg["tracking"]["pixels"])
        return n * samples * point_ops(c_dim, "inputs")
    n = int(cfg["mapping"]["pixels"])
    ops = n * samples * point_ops(c_dim, "all")
    if importance:
        ops += n * int(r["n_stratified"]) * (
            sample_ops(c_dim) + decoder_ops(c_dim, 1) + COMPOSITE_OPS)
    return ops
