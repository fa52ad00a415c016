"""Kernels K1, K2 and K3 on the GPU against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: forward atol 1e-5 (the same float32 products, FMA-contracted
on the card); gradients atol 1e-4 (atomic adds and a warp reduction sum
in another order than ``index_add_`` and ``torch.sum``).  K3 is also
held against K1 on the same quad, at atol 1e-5.  K2's point orders
(one row for all points, a new row at every point, run and block edges,
points past the border, ray-ordered points) are held at 1e-5 of the
largest value, ``chip_smoke.py``'s limit: runs merged in registers and
vector atomics sum in another order than ``index_add_``.
"""

import numpy as np
import pytest
import torch

from myslam_torch.models.planes import make_layout
from myslam_torch.ops import cuda_sample, smem_sample
from myslam_torch.ops.plane_sample import pack_quad, sample_fused
from myslam_torch.tools.bench_sample_bwd import layouts, loop_points
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

BOUND = np.array([[-1.9, 7.94], [-2.2, 4.52], [-2.5, 2.54]], np.float32)
ROOM0_BOUND = np.array([[-1.9, 8.18], [-2.2, 4.58], [-2.5, 2.78]],
                       np.float32)
C_DIM = 8
N_PTS = 700


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(seed):
    layout = make_layout(BOUND, [0.48, 0.24], C_DIM)
    rng = np.random.default_rng(seed)
    atlas = rng.normal(size=(layout.total_rows, C_DIM)).astype(np.float32)
    p_nor = rng.uniform(-1.05, 1.05, size=(N_PTS, 3)).astype(np.float32)
    gbar = rng.normal(size=(N_PTS, 2 * 4 * C_DIM)).astype(np.float32)
    return layout, atlas, p_nor, gbar


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions(dev, dtype):
    layout, atlas, p_nor, gbar = _inputs(7)
    quad = pack_quad(torch.tensor(atlas, device=dev), layout).to(dtype)
    p = torch.tensor(p_nor, device=dev)
    g = torch.tensor(gbar, device=dev)
    before = dict(cuda_sample.LAUNCHES)
    out = cuda_sample.plane_sample_fwd(quad, layout, p)
    qg, pg = cuda_sample.plane_sample_bwd(g, quad, layout, p)
    torch.cuda.synchronize()
    assert cuda_sample.LAUNCHES == {
        **before, "plane_sample_fwd": before["plane_sample_fwd"] + 1,
        "plane_sample_bwd": before["plane_sample_bwd"] + 1}
    ref = cuda_sample.plane_sample_fwd_ref(quad, layout, p)
    rqg, rpg = cuda_sample.plane_sample_bwd_ref(g, quad, layout, p)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(qg, rqg, atol=1e-4, rtol=0)
    torch.testing.assert_close(pg, rpg, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_sample_fused_autograd_on_the_card_matches_the_cpu(dev):
    """Both gradients through pack_quad, on the card (K1/K2) and on the
    CPU (plain versions); with a frozen quad K2 skips the quad gradient."""
    layout, atlas, p_nor, gbar = _inputs(8)
    grads = {}
    for d in (torch.device("cpu"), dev):
        a = torch.tensor(atlas, device=d, requires_grad=True)
        p = torch.tensor(p_nor, device=d, requires_grad=True)
        out = sample_fused(pack_quad(a, layout), layout, p)
        out.backward(torch.tensor(gbar, device=d))
        grads[d.type] = (out.detach().cpu(), a.grad.cpu(), p.grad.cpu())
    for got, ref in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)

    quad = pack_quad(torch.tensor(atlas, device=dev), layout)
    p = torch.tensor(p_nor, device=dev, requires_grad=True)
    sample_fused(quad, layout, p).backward(torch.tensor(gbar, device=dev))
    assert quad.grad is None
    torch.testing.assert_close(p.grad.cpu(), grads["cpu"][2], atol=1e-4,
                               rtol=1e-5)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    layout, atlas, p_nor, gbar = _inputs(9)
    quad = pack_quad(torch.tensor(atlas, device=dev), layout)
    p = torch.tensor(p_nor, device=dev)
    with pytest.raises(TypeError):  # float16 quad
        cuda_sample.plane_sample_fwd(quad.half(), layout, p)
    with pytest.raises(ValueError):  # not contiguous
        cuda_sample.plane_sample_fwd(quad, layout, p.t().contiguous().t())
    with pytest.raises(ValueError):  # quad from another layout
        cuda_sample.plane_sample_fwd(quad[:-1], layout, p)
    with pytest.raises(ValueError):  # quad on the CPU, points on the card
        cuda_sample.plane_sample_fwd(quad.cpu(), layout, p)


@pytest.mark.cuda
@pytest.mark.parametrize("bound,res,c_dim,dtype,blocks", [
    (BOUND, [0.48, 0.24], C_DIM, torch.bfloat16, 1),
    (ROOM0_BOUND, [0.24, 0.06], 32, torch.bfloat16, 3),
    (ROOM0_BOUND, [0.24, 0.06], 32, torch.float32, 6),
])
def test_smem_kernel_matches_plain_version_and_k1(dev, bound, res, c_dim,
                                                  dtype, blocks):
    """K3 in one block and in clusters of 3 and 6 blocks."""
    layout = make_layout(bound, res, c_dim)
    rng = np.random.default_rng(10)
    atlas = 0.01 * rng.normal(size=(layout.total_rows, c_dim))
    p = torch.tensor(rng.uniform(-1.05, 1.05, size=(5000, 3)),
                     dtype=torch.float32, device=dev)
    quad = pack_quad(torch.tensor(atlas, dtype=torch.float32, device=dev),
                     layout).to(dtype)
    before = cuda_sample.LAUNCHES["plane_sample_fwd_smem"]
    out = smem_sample.plane_sample_fwd_smem(quad, layout, p)
    torch.cuda.synchronize()
    assert cuda_sample.LAUNCHES["plane_sample_fwd_smem"] == before + 1
    assert smem_sample.LAST_LAUNCH["cluster_blocks"] == blocks
    assert smem_sample.LAST_LAUNCH["grid_blocks"] % blocks == 0
    ref = cuda_sample.plane_sample_fwd_ref(quad, layout, p)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(
        out, cuda_sample.plane_sample_fwd(quad, layout, p), atol=1e-5,
        rtol=0)
    # make_sample_quad_smem casts an f32 quad to its atlas dtype.
    built = smem_sample.make_sample_quad_smem(layout, 5000, dtype)
    torch.testing.assert_close(built(quad.float(), p), out, atol=0, rtol=0)


def _bwd_points(kind: str, rng) -> np.ndarray:
    """Points in the orders K2's walk has to get right."""
    R, B = cuda_sample.BWD_RUN, cuda_sample.BWD_WARPS
    cell = np.array([0.1, -0.2, 0.3])  # one cell on every plane
    if kind == "one_row":
        return cell + rng.uniform(0, 1e-3, size=(3 * R + 5, 3))
    if kind == "new_row_each_point":  # two far cells, alternating
        pts = np.tile(cell, (2 * R + 3, 1))
        pts[1::2] = -0.7
        return pts
    if kind == "past_the_border":
        return rng.uniform(-1.3, 1.3, size=(R * B + 9, 3))
    n = {"n_1": 1, "n_run_minus_1": R - 1, "n_run_plus_1": R + 1,
         "n_ragged_block": 3 * R * B + 7}[kind]
    return rng.uniform(-1.05, 1.05, size=(n, 3))


def _assert_within(got, ref, what):
    rel = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
    assert rel <= 1e-5, f"{what}: {rel:.3e} of the largest value"


def _check_bwd(dev, layout, quad, p, gbar):
    ref_qg, ref_pg = cuda_sample.plane_sample_bwd_ref(gbar, quad, layout, p)
    before = cuda_sample.LAUNCHES["plane_sample_bwd"]
    qg, pg = cuda_sample.plane_sample_bwd(gbar, quad, layout, p)
    none, pg_only = cuda_sample.plane_sample_bwd(gbar, quad, layout, p,
                                                 need_quad_grad=False)
    torch.cuda.synchronize()
    assert cuda_sample.LAUNCHES["plane_sample_bwd"] == before + 2
    assert none is None
    _assert_within(qg, ref_qg, "quad_grad")
    _assert_within(pg, ref_pg, "p_grad")
    _assert_within(pg_only, ref_pg, "p_grad without quad_grad")
    outside = (p.abs() > 1.0).all(dim=1)
    if bool(outside.any()):
        assert float(pg[outside].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", [
    "one_row", "new_row_each_point", "n_1", "n_run_minus_1", "n_run_plus_1",
    "n_ragged_block", "past_the_border"])
def test_bwd_kernel_walks_every_point_order(dev, kind, dtype):
    layout = make_layout(BOUND, [0.48, 0.24], C_DIM)
    rng = np.random.default_rng(11)
    atlas = torch.tensor(rng.normal(size=(layout.total_rows, C_DIM)),
                         dtype=torch.float32, device=dev)
    quad = pack_quad(atlas, layout).to(dtype).contiguous()
    pts = _bwd_points(kind, rng)
    p = torch.tensor(pts, dtype=torch.float32, device=dev)
    gbar = torch.tensor(rng.normal(size=(len(pts), 2 * 4 * C_DIM)),
                        dtype=torch.float32, device=dev)
    _check_bwd(dev, layout, quad, p, gbar)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_on_ray_ordered_points(dev, dtype):
    """The loop's own points: frame 0's rays, 40 samples each, ray-major,
    on the room's SDF layout at c_dim 8."""
    cfg = load_config("configs/Synthetic/room.yaml", DEFAULT_CONFIG)
    cfg["model"]["c_dim"] = C_DIM
    layout = layouts(cfg)["sdf"]
    rng = np.random.default_rng(12)
    atlas = torch.tensor(rng.normal(size=(layout.total_rows, C_DIM)),
                         dtype=torch.float32, device=dev)
    quad = pack_quad(atlas, layout).to(dtype).contiguous()
    p = loop_points(cfg, 300, dev, seed=3)
    gbar = torch.tensor(rng.normal(size=(p.shape[0], 2 * 4 * C_DIM)),
                        dtype=torch.float32, device=dev)
    _check_bwd(dev, layout, quad, p, gbar)


@pytest.mark.cuda
@pytest.mark.parametrize("res,c_dim", [
    ([0.48], 8), ([0.48, 0.24, 0.12], 8), ([0.48, 0.24, 0.12, 0.06], 4),
    ([0.48, 0.24], 64)])
def test_bwd_kernel_levels_and_widths(dev, res, c_dim):
    """1, 3 and 4 levels, and rows wider than 128 channels (two passes
    of the warp, p_grad added to across them)."""
    layout = make_layout(BOUND, res, c_dim)
    rng = np.random.default_rng(13)
    atlas = torch.tensor(rng.normal(size=(layout.total_rows, c_dim)),
                         dtype=torch.float32, device=dev)
    quad = pack_quad(atlas, layout).contiguous()
    p = torch.tensor(rng.uniform(-1.05, 1.05, size=(999, 3)),
                     dtype=torch.float32, device=dev)
    gbar = torch.tensor(rng.normal(size=(999, len(res) * 4 * c_dim)),
                        dtype=torch.float32, device=dev)
    _check_bwd(dev, layout, quad, p, gbar)
