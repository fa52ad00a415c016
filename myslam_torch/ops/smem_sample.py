"""Tri-plane sample forward with the coarse level resident in shared
memory: kernel K3 and its plain version.

The counterpart of ``myslam_tpu/ops/pallas_sample.py``'s VMEM-resident
kernel (B2, ``make_sample_quad_pallas_vmem``) and its glue (B3,
``sample_fused_pallas`` with ``plane_indices_and_fracs``).  B2 kept the
whole quad atlas in the TPU's VMEM; an H100 block holds at most 227 KB
of shared memory, so K3 (``myslam_torch/csrc/plane_sample_smem.cu``)
keeps the coarse level there, split over a thread-block cluster where it
exceeds one block's budget, and reads finer rows from device memory.
It takes K1's walk (runs of ``SMEM_RUN`` consecutive points per warp,
reusing the rows they share).  It computes the same function as K1
(``ops/cuda_sample.py``), from
``p_nor`` to the (N, L*4C) float32 corner features, on the quad cast to
``atlas_dtype`` (bfloat16 by default, as in B2); the weighting runs in
float32.

A layout whose coarse level does not fit in one cluster's shared memory
makes the planner raise ``ValueError``; there is no switch to K1.  K3 is
not on the SLAM loop's path (B2 was not on the JAX package's either):
``tools/bench_scatter.py`` drives it.

Dispatch as in ``ops/cuda_sample.py``: CPU tensors take the plain
version, CUDA tensors launch K3 or raise.  Each launch adds one to
``cuda_sample.LAUNCHES["plane_sample_fwd_smem"]``.
"""

from __future__ import annotations

import ctypes

import torch

from myslam_torch.models.planes import PlaneLayout
from myslam_torch.ops import cuda_sample

# Shared memory one block may give the coarse rows (of the H100's 232,448
# bytes per block), and the portable thread-block cluster size.
SMEM_BUDGET = 224 * 1024
MAX_CLUSTER = 8
# Consecutive points a K3 warp walks at a time (at most a tile of 32),
# reusing the rows they share, as K1 does (cuda_sample.FWD_RUN).
SMEM_RUN = 16

# The shape of K3's last launch: cluster size, blocks launched, coarse
# rows per block, points per run, a block's shared memory and where the
# walk keeps a tile's plane coordinates ("shared" memory after the coarse
# rows where they leave room, else "registers").
LAST_LAUNCH: dict = {}


def plane_indices_and_fracs(layout: PlaneLayout, p_nor: torch.Tensor):
    """Quad-atlas row index (N, P) int32 and bilinear fractions wx, wy
    (N, P) per (point, plane), P = 3L: align_corners=True with border
    clamp, the clamp -> floor -> float cell index sequence of K1's
    prologue (``cuda_sample.plane_coords``)."""
    idxs, wxs, wys = [], [], []
    for _, _, au, av, H, W, off in layout.planes():
        cell, wx, wy, _, _ = cuda_sample.plane_coords(p_nor, au, av, H, W)
        idxs.append((off + cell).to(torch.int32))
        wxs.append(wx)
        wys.append(wy)
    return (torch.stack(idxs, -1), torch.stack(wxs, -1),
            torch.stack(wys, -1))


def coarse_rows(layout: PlaneLayout) -> int:
    """Rows of the coarse level (level 0's three planes), which lead the
    atlas."""
    return sum(H * W for H, W in layout.shapes[0])


def coarse_cluster_blocks(layout: PlaneLayout, dtype) -> int:
    """Blocks of a cluster that hold the coarse level in shared memory:
    ceil(coarse bytes / SMEM_BUDGET).  Raises ValueError beyond
    MAX_CLUSTER blocks."""
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = coarse_rows(layout) * 4 * layout.c_dim * elt
    blocks = -(-nbytes // SMEM_BUDGET)
    if blocks > MAX_CLUSTER:
        raise ValueError(
            f"coarse level of {nbytes} bytes needs {blocks} blocks of "
            f"{SMEM_BUDGET} bytes; a cluster holds at most {MAX_CLUSTER} "
            f"({MAX_CLUSTER * SMEM_BUDGET} bytes)")
    return blocks


def plane_sample_fwd_smem(quad: torch.Tensor, layout: PlaneLayout,
                          p_nor: torch.Tensor) -> torch.Tensor:
    """Tri-plane sample forward (N, L*4C) float32.  CPU tensors: the
    plain version (``cuda_sample.plane_sample_fwd_ref``); CUDA tensors:
    kernel K3."""
    if p_nor.device.type == "cpu" and quad.device.type == "cpu":
        return cuda_sample.plane_sample_fwd_ref(quad, layout, p_nor)
    cuda_sample._check_common(quad, layout, p_nor)
    blocks = coarse_cluster_blocks(layout, quad.dtype)
    rows = coarse_rows(layout)
    per_block = -(-rows // blocks)
    n = p_nor.shape[0]
    C4 = 4 * layout.c_dim
    out = torch.empty((n, layout.n_levels * C4), dtype=torch.float32,
                      device=p_nor.device)
    if n == 0:
        return out
    lib = cuda_sample.load()
    info = (ctypes.c_int * 3)()  # blocks, shared memory, coordinates
    err = lib.plane_sample_fwd_smem(
        p_nor.data_ptr(), quad.data_ptr(), int(quad.dtype == torch.bfloat16),
        out.data_ptr(), n, C4, layout.n_levels,
        ctypes.cast(cuda_sample._plane_table(layout), ctypes.c_void_p),
        rows, blocks, per_block, SMEM_RUN, ctypes.addressof(info),
        torch.cuda.current_stream(p_nor.device).cuda_stream)
    cuda_sample._raise_on(err, "plane_sample_fwd_smem")
    cuda_sample.LAUNCHES["plane_sample_fwd_smem"] += 1
    LAST_LAUNCH.update(cluster_blocks=blocks, grid_blocks=info[0],
                       rows_per_block=per_block, run=SMEM_RUN,
                       smem_bytes=info[1],
                       coords="shared" if info[2] else "registers")
    return out


def make_sample_quad_smem(layout: PlaneLayout, n_points: int,
                          atlas_dtype=torch.bfloat16):
    """Build sample(quad (S, 4C), p_nor (n_points, 3)) -> (n_points,
    L*4C) float32, the counterpart of B2's make_sample_quad_pallas_vmem.

    The quad is cast to ``atlas_dtype``; the cluster is planned here, so
    a layout whose coarse level does not fit raises ValueError now.
    """
    coarse_cluster_blocks(layout, atlas_dtype)

    def sample(quad: torch.Tensor, p_nor: torch.Tensor) -> torch.Tensor:
        if p_nor.shape[0] != n_points:
            raise ValueError(f"built for {n_points} points, got "
                             f"{p_nor.shape[0]}")
        return plane_sample_fwd_smem(quad.to(atlas_dtype).contiguous(),
                                     layout, p_nor.contiguous())

    return sample


def sample_fused_smem(quad: torch.Tensor, layout: PlaneLayout,
                      p_nor: torch.Tensor) -> torch.Tensor:
    """Drop-in forward for the sample through K3 (the counterpart of B3,
    ``sample_fused_pallas``); hot callers build once with
    make_sample_quad_smem."""
    return make_sample_quad_smem(layout, p_nor.shape[0])(quad, p_nor)
