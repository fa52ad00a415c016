"""K1's launch plan and the plain forward on ray-ordered points.

Kernel K1 (``ops/cuda_sample.py::plane_sample_fwd``) gives each warp a
run of consecutive points and loads a plane's row only where it differs
from the point before's.  The kernel runs only on the card
(``tests/test_torch_cuda.py``); here:

  * the wrapper's pure-Python launch plan, walked as the kernel indexes
    it, covers every point exactly once and leaves no block empty, at
    each run length ``tools/bench_sample_fwd.py --runs`` sweeps;
  * the plain forward, the oracle of K1 and K3, against JAX's
    ``sample_fused`` on ray-ordered points with hot rows.

Tolerance: float32 atol 1e-5 (the same products, summed over three
orientations in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.models.planes import make_layout as j_make_layout
from myslam_torch.models.planes import make_layout
from myslam_torch.ops import cuda_sample, smem_sample
from myslam_torch.ops.plane_sample import pack_quad
from myslam_torch.tools.bench_sample_bwd import row_updates
from test_torch_sample_bwd import BOUND, _ray_points

torch.set_num_threads(2)  # several test workers share the CPU

C_DIM = 8
R, B = cuda_sample.FWD_RUN, cuda_sample.FWD_WARPS
TILE = 32  # FWD_TILE in csrc/plane_common.cuh


def _walk(n: int):
    """Points each warp of the plan walks, indexed as the kernel's walk
    (fwd_walk) does: warp g of the grid takes runs g, g + warps*blocks,
    ..., run r being points [r*run, min((r+1)*run, n))."""
    run, warps, blocks = cuda_sample.fwd_launch_plan(n)
    stride = warps * blocks
    seen = np.zeros(n, np.int64)
    empty_blocks = 0
    for b in range(blocks):
        walked = 0
        for w in range(warps):
            for first in range((b * warps + w) * run, n, stride * run):
                seen[first:min(first + run, n)] += 1
                walked += 1
        empty_blocks += walked == 0
    return (run, warps, blocks), seen, empty_blocks


@pytest.mark.parametrize("run", [R, 4, 32])
@pytest.mark.parametrize("n", [1, R - 1, R, R + 1, R * B - 1, R * B + 1,
                               3 * R * B + 7, 160_000])
def test_fwd_launch_plan_covers_every_point_once(monkeypatch, n, run):
    monkeypatch.setattr(cuda_sample, "FWD_RUN", run)
    (got_run, warps, blocks), seen, empty = _walk(n)
    assert (got_run, warps) == (run, cuda_sample.FWD_WARPS)
    assert np.all(seen == 1)
    assert empty == 0
    # One run per warp: the C entry refuses a plan whose blocks leave
    # points out or hold no run.
    assert blocks == -(-n // (run * warps))
    assert (blocks - 1) * run * warps < n <= blocks * run * warps


def test_runs_fit_one_tile():
    """The C entries refuse a run longer than a tile of 32 points."""
    assert 1 <= cuda_sample.FWD_RUN <= TILE
    assert 1 <= smem_sample.SMEM_RUN <= TILE


@pytest.mark.parametrize("levels", [[0.48, 0.24], [0.48]])
def test_plain_fwd_matches_jax_on_ray_ordered_points(levels):
    layout = make_layout(BOUND, levels, C_DIM)
    jlayout = j_make_layout(jnp.asarray(BOUND), levels, C_DIM)
    rng = np.random.default_rng(22)
    atlas = rng.normal(size=(layout.total_rows, C_DIM)).astype(np.float32)
    p_nor = _ray_points()
    # Hot rows: consecutive samples of a ray share the cells that K1's
    # walk keeps in registers, so runs of R leave well under the
    # (point, plane) row reads of one per point.
    counts = row_updates(layout, torch.tensor(p_nor), R)
    assert counts["merged"] < 0.6 * counts["updates"]

    out = cuda_sample.plane_sample_fwd_ref(
        pack_quad(torch.tensor(atlas), layout), layout, torch.tensor(p_nor))
    ref = jps.sample_fused(jps.pack_quad(jnp.asarray(atlas), jlayout),
                           jlayout, jnp.asarray(p_nor))
    assert out.shape == (len(p_nor), len(levels) * 4 * C_DIM)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
