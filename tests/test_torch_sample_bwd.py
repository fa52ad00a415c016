"""K2's launch plan and its plain version on ray-ordered points.

Kernel K2 (``ops/cuda_sample.py::plane_sample_bwd``) walks runs of
consecutive points, one run per warp, and merges the quad-gradient
updates of points that share a row.  The kernel runs only on the card
(``tests/test_torch_cuda.py``); here:

  * the wrapper's pure-Python launch plan, walked as the kernel indexes
    it, covers every point exactly once and leaves no block empty;
  * the host count of merged row updates that ``chip_smoke.py`` prints;
  * the plain version, the kernel's oracle, against the JAX VJP
    ``_sample_fused_bwd`` on ray-ordered points with hot rows: 3 rays of
    40 samples from one camera, whose first samples share the camera's
    cells.  The JAX side scatters every plane (ONEHOT_MAX_ROWS = 0).

Tolerance: float32 atol 1e-4 on both gradients (sums of up to 120
products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.models.planes import make_layout as j_make_layout
from myslam_torch.core.geometry import normalize_3d_coordinate, rays_from_uv
from myslam_torch.core.sampling import TorchDraws, depth_guided_z_vals
from myslam_torch.models.planes import make_layout
from myslam_torch.ops import cuda_sample
from myslam_torch.ops.plane_sample import pack_quad
from myslam_torch.tools.bench_sample_bwd import row_updates

torch.set_num_threads(2)  # several test workers share the CPU

BOUND = np.array([[-1.9, 7.94], [-2.2, 4.52], [-2.5, 2.54]], np.float32)
C_DIM = 8
R, B = cuda_sample.BWD_RUN, cuda_sample.BWD_WARPS


def _walk(n: int):
    """Points each warp of the plan walks, indexed as the kernel does:
    warp w of block b starts at (b * warps + w) * run."""
    run, warps, blocks = cuda_sample.bwd_launch_plan(n)
    seen = np.zeros(n, np.int64)
    empty_blocks = 0
    for b in range(blocks):
        firsts = [(b * warps + w) * run for w in range(warps)]
        empty_blocks += all(f >= n for f in firsts)
        for f in firsts:
            if f < n:
                seen[f:min(f + run, n)] += 1
    return (run, warps, blocks), seen, empty_blocks


@pytest.mark.parametrize("n", [1, R - 1, R, R + 1, R * B - 1, R * B + 1,
                               3 * R * B + 7, 160_000])
def test_bwd_launch_plan_covers_every_point_once(n):
    (run, warps, blocks), seen, empty = _walk(n)
    assert (run, warps) == (cuda_sample.BWD_RUN, cuda_sample.BWD_WARPS)
    assert np.all(seen == 1)
    assert empty == 0
    assert blocks == -(-n // (run * warps))


def test_row_updates_merge_consecutive_points_within_a_run():
    layout = make_layout(BOUND, [0.48], C_DIM)
    cell_a, cell_b = [0.1, -0.2, 0.3], [-0.7, -0.7, -0.7]
    # a a a b | b a  with runs of 4: per plane, rows a, b in the first
    # run and b, a in the second.
    p = torch.tensor([cell_a] * 3 + [cell_b] * 2 + [cell_a])
    got = row_updates(layout, p, 4)
    assert got == {"updates": 6 * 3, "merged": 4 * 3, "rows_touched": 6}


def _ray_points():
    """3 rays x 40 samples from one camera, ray-major, normalized."""
    c2w = torch.eye(4)
    c2w[:3, 3] = torch.tensor([2.0, 1.0, 0.0])
    i = torch.tensor([10.0, 30.0, 55.0])
    j = torch.tensor([12.0, 40.0, 20.0])
    rays_o, rays_d = rays_from_uv(i, j, c2w, 50.0, 50.0, 32.0, 24.0)
    depth = torch.tensor([2.5, 3.1, 1.7])
    z = depth_guided_z_vals(TorchDraws(0, "cpu"), depth, 0.06, 32, 8, True)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    bound = torch.as_tensor(BOUND)
    return normalize_3d_coordinate(pts.reshape(-1, 3), bound).numpy()


def test_plain_bwd_matches_jax_on_ray_ordered_points(monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)
    layout = make_layout(BOUND, [0.48, 0.24], C_DIM)
    jlayout = j_make_layout(jnp.asarray(BOUND), [0.48, 0.24], C_DIM)
    rng = np.random.default_rng(21)
    atlas = rng.normal(size=(layout.total_rows, C_DIM)).astype(np.float32)
    p_nor = _ray_points()
    gbar = rng.normal(size=(len(p_nor), 2 * 4 * C_DIM)).astype(np.float32)
    # Hot rows: the camera's cells take many points, so merging the
    # points of each ray leaves well under half the row updates.
    counts = row_updates(layout, torch.tensor(p_nor), 40)
    assert counts["merged"] < 0.5 * counts["updates"]

    quad = pack_quad(torch.tensor(atlas), layout)
    qg, pg = cuda_sample.plane_sample_bwd_ref(
        torch.tensor(gbar), quad, layout, torch.tensor(p_nor))
    jquad = jps.pack_quad(jnp.asarray(atlas), jlayout)
    _, vjp = jax.vjp(lambda q, p: jps.sample_fused(q, jlayout, p), jquad,
                     jnp.asarray(p_nor))
    jqg, jpg = vjp(jnp.asarray(gbar))
    np.testing.assert_allclose(qg.numpy(), np.asarray(jqg), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jpg), atol=1e-4,
                               rtol=1e-5)
