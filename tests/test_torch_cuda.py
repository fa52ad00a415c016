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
vector atomics sum in another order than ``index_add_``.  K1 and K3
walk the same point orders (and a run that crosses a tile's end), 1-4
levels, c_dim 8/32/64 and both quad types, held against the plain
version and each other at the same limit.  K1 also on the meshing
path's grid-ordered volume chunks and on a chunk of the full-frame image
renderer (1,638,400 ray-ordered points, f32 quad), at the same limit;
the image renderer itself on the card against the CPU at atol 1e-4 (the
decoders' matmuls and the compositing's products round in another
order on the card).  Marching, the
depth rasterizer and the mesh culling's visibility run on the card and
the CPU with the same rounding (elementwise operations, a stable sort, a
minimum): held bit for bit.  The banded K1 / K2 (a map shard's band
atlas, ``parallel/plane_shard.py``) on 2 and 3 shards and both quad
types against their plain banded versions at 1e-5 of the largest value
(also where a band owns no point or every point, where ownership
alternates point by point, at 1 and chunk +- 1 points, at 1, 3 and 4
levels and at c_dim 64), their parts summed over the shards against the
unbanded plain version, and ``SampleBanded``'s gradients on the card
against the CPU's.
"""

import ctypes


import numpy as np
import pytest
import torch

from myslam_torch.models.planes import make_layout
from myslam_torch.ops import cuda_sample, smem_sample
from myslam_torch.ops.plane_sample import pack_quad, sample_fused
from myslam_torch.tools.bench_sample_bwd import band_quads, layouts, \
    loop_points
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
@pytest.mark.parametrize("bound,res,c_dim,dtype,blocks,coords", [
    (BOUND, [0.48, 0.24], C_DIM, torch.bfloat16, 1, "shared"),
    (ROOM0_BOUND, [0.24, 0.06], 32, torch.bfloat16, 3, "registers"),
    (ROOM0_BOUND, [0.24, 0.06], 32, torch.float32, 6, "registers"),
])
def test_smem_kernel_matches_plain_version_and_k1(dev, bound, res, c_dim,
                                                  dtype, blocks, coords):
    """K3 in one block and in clusters of 3 and 6 blocks, with the tile's
    coordinates in shared memory and, where the coarse rows fill it, in
    registers."""
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
    assert smem_sample.LAST_LAUNCH["coords"] == coords
    ref = cuda_sample.plane_sample_fwd_ref(quad, layout, p)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(
        out, cuda_sample.plane_sample_fwd(quad, layout, p), atol=1e-5,
        rtol=0)
    # make_sample_quad_smem casts an f32 quad to its atlas dtype.
    built = smem_sample.make_sample_quad_smem(layout, 5000, dtype)
    torch.testing.assert_close(built(quad.float(), p), out, atol=0, rtol=0)


def _banded_points(kind: str, n_pts: int, rng) -> np.ndarray:
    """Points whose ownership on 2 bands is: mixed ("uniform"); all on
    band 0, band 1 owning no point ("one_side"); alternating point by
    point ("alternating": even points on band 0, odd on band 1).  A
    plane's band split runs along its v axis (y for xy, z for xz and
    yz), so the sides are y and z both below or both above the middle."""
    p = rng.uniform(-1.05, 1.05, size=(n_pts, 3)).astype(np.float32)
    if kind != "uniform":
        side = np.where(np.arange(n_pts) % 2 == 1, 1.0, -1.0) \
            if kind == "alternating" else -np.ones(n_pts)
        p[:, 1:] = (side[:, None] * rng.uniform(0.2, 1.0, size=(n_pts, 2))
                    ).astype(np.float32)
    return p


CHUNK = cuda_sample.BWD_BANDED_CHUNK


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,kind,n_pts,res,c_dim", [
    (2, "uniform", N_PTS, [0.48, 0.24], C_DIM),
    (3, "uniform", N_PTS, [0.48, 0.24], C_DIM),
    (2, "one_side", N_PTS, [0.48, 0.24], C_DIM),
    (2, "alternating", N_PTS, [0.48, 0.24], C_DIM),
    (2, "uniform", 1, [0.48, 0.24], C_DIM),
    (2, "uniform", CHUNK - 1, [0.48, 0.24], C_DIM),
    (2, "uniform", CHUNK + 1, [0.48, 0.24], C_DIM),
    (2, "uniform", N_PTS, [0.24], C_DIM),
    (2, "uniform", N_PTS, [0.96, 0.48, 0.24], C_DIM),
    (3, "uniform", N_PTS, [0.96, 0.48, 0.24, 0.12], C_DIM),
    (2, "alternating", N_PTS, [0.48, 0.24], 64),
])
def test_banded_kernels_match_plain_versions(dev, dtype, n, kind, n_pts,
                                             res, c_dim):
    """Banded K1 / K2 on every band against their plain versions, with
    and without the quad gradient, and summed over the bands against the
    unbanded plain version; a band that owns no point gets zeros."""
    layout = make_layout(BOUND, res, c_dim)
    rng = np.random.default_rng(10)
    atlas = rng.normal(size=(layout.total_rows, c_dim)).astype(np.float32)
    p = torch.tensor(_banded_points(kind, n_pts, rng), device=dev)
    g = torch.tensor(rng.normal(size=(n_pts, layout.n_levels * 4 * c_dim)),
                     dtype=torch.float32, device=dev)
    ts, bands = band_quads(layout, torch.tensor(atlas, device=dev), n, dtype)
    fwd_sum, pg_sum, qgs = 0, 0, []
    for d, (band, quad) in enumerate(bands):
        before = dict(cuda_sample.LAUNCHES)
        out = cuda_sample.plane_sample_fwd_banded(quad, band, p)
        qg, pg = cuda_sample.plane_sample_bwd_banded(g, quad, band, p)
        none, pg_only = cuda_sample.plane_sample_bwd_banded(
            g, quad, band, p, need_quad_grad=False)
        torch.cuda.synchronize()
        assert cuda_sample.LAUNCHES == {
            **before, "plane_sample_fwd_banded":
            before["plane_sample_fwd_banded"] + 1,
            "plane_sample_bwd_banded": before["plane_sample_bwd_banded"] + 2}
        assert none is None
        ref = cuda_sample.plane_sample_fwd_banded_ref(quad, band, p)
        rqg, rpg = cuda_sample.plane_sample_bwd_banded_ref(g, quad, band, p)
        _assert_within(out, ref, "banded forward")
        _assert_within(qg, rqg, "banded quad_grad")
        _assert_within(pg, rpg, "banded p_grad")
        _assert_within(pg_only, rpg, "banded p_grad without quad_grad")
        listed = int(cuda_sample.band_lists(band, p)[2].sum())
        if kind == "one_side":
            assert listed == (n_pts if d == 0 else 0)
        if kind == "one_side" and d == 1:  # owns no point
            assert not out.any() and not qg.any() and not pg.any()
            assert not pg_only.any()
        elif kind == "alternating":
            assert listed == (n_pts + 1 - d) // 2
        fwd_sum, pg_sum = fwd_sum + out, pg_sum + pg
        qgs.append(qg.cpu().numpy())
    quad = pack_quad(torch.tensor(atlas, device=dev), layout).to(dtype)
    _assert_within(fwd_sum, cuda_sample.plane_sample_fwd_ref(quad, layout, p),
                   "the shards' forward summed")
    rqg, rpg = cuda_sample.plane_sample_bwd_ref(g, quad, layout, p)
    _assert_within(pg_sum, rpg, "the shards' p_grad summed")
    _assert_within(torch.tensor(ts.unshard_atlas(np.concatenate(qgs))),
                   rqg.cpu(), "the shards' quad_grad, unsharded")


@pytest.mark.cuda
def test_sample_banded_autograd_on_the_card_matches_the_cpu(dev):
    from myslam_torch.ops.plane_sample import sample_banded
    from myslam_torch.parallel import plane_shard as tps

    layout, atlas, p_nor, gbar = _inputs(11)
    ts = tps.ShardedPlaneLayout(layout, 2)
    rows = ts.local_rows
    grads = {}
    for d in (torch.device("cpu"), dev):
        sharded = torch.tensor(ts.shard_atlas(atlas), device=d)
        local = sharded[:rows].clone().requires_grad_()
        p = torch.tensor(p_nor, device=d, requires_grad=True)
        quad = tps.pack_local(local, tps.first_rows(sharded[rows:], ts), ts,
                              False)
        out = sample_banded(quad, ts.band(0), p)
        out.backward(torch.tensor(gbar, device=d))
        grads[d.type] = (out.detach().cpu(), local.grad.cpu(), p.grad.cpu())
    for got, ref in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_banded_entries_refuse_a_missing_band_table(dev):
    layout, atlas, p_nor, _ = _inputs(12)
    _, bands = band_quads(layout, torch.tensor(atlas, device=dev), 2,
                          torch.float32)
    band, quad = bands[0]
    p = torch.tensor(p_nor, device=dev)
    out = torch.empty((N_PTS, 2 * 4 * C_DIM), device=dev)
    planes, _ = cuda_sample._band_tables(band)
    run, warps, blocks = cuda_sample.fwd_launch_plan(N_PTS)
    err = cuda_sample.load().plane_sample_fwd_banded(
        p.data_ptr(), quad.data_ptr(), 0, out.data_ptr(), N_PTS, 4 * C_DIM,
        2, ctypes.cast(planes, ctypes.c_void_p), None, run, warps, blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    assert err != 0


def _walk_points(kind: str, rng, R: int, B: int) -> np.ndarray:
    """Points in the orders a walk of runs of R points by blocks of B
    warps has to get right."""
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
         "n_tile_plus_1": 33, "n_ragged_block": 3 * R * B + 7}[kind]
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
    pts = _walk_points(kind, rng, cuda_sample.BWD_RUN, cuda_sample.BWD_WARPS)
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


def _check_fwd(layout, quad, p):
    """K1 and K3 against the plain version and each other, one launch
    each."""
    ref = cuda_sample.plane_sample_fwd_ref(quad, layout, p)
    before = dict(cuda_sample.LAUNCHES)
    out = cuda_sample.plane_sample_fwd(quad, layout, p)
    out3 = smem_sample.plane_sample_fwd_smem(quad, layout, p)
    torch.cuda.synchronize()
    assert cuda_sample.LAUNCHES == {
        **before, "plane_sample_fwd": before["plane_sample_fwd"] + 1,
        "plane_sample_fwd_smem": before["plane_sample_fwd_smem"] + 1}
    assert out.shape == out3.shape == ref.shape
    _assert_within(out, ref, "K1")
    _assert_within(out3, ref, "K3")
    _assert_within(out3, out, "K3 against K1")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", [
    "one_row", "new_row_each_point", "n_1", "n_run_minus_1", "n_run_plus_1",
    "n_tile_plus_1", "n_ragged_block", "past_the_border"])
def test_fwd_kernels_walk_every_point_order(dev, kind, dtype):
    layout = make_layout(BOUND, [0.48, 0.24], C_DIM)
    rng = np.random.default_rng(14)
    atlas = torch.tensor(rng.normal(size=(layout.total_rows, C_DIM)),
                         dtype=torch.float32, device=dev)
    quad = pack_quad(atlas, layout).to(dtype).contiguous()
    pts = _walk_points(kind, rng, cuda_sample.FWD_RUN, cuda_sample.FWD_WARPS)
    _check_fwd(layout, quad, torch.tensor(pts, dtype=torch.float32,
                                          device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_kernels_on_ray_ordered_points(dev, dtype):
    """The loop's own points (frame 0's rays, ray-major) on the room's
    SDF layout at c_dim 8."""
    cfg = load_config("configs/Synthetic/room.yaml", DEFAULT_CONFIG)
    cfg["model"]["c_dim"] = C_DIM
    layout = layouts(cfg)["sdf"]
    rng = np.random.default_rng(15)
    atlas = torch.tensor(rng.normal(size=(layout.total_rows, C_DIM)),
                         dtype=torch.float32, device=dev)
    quad = pack_quad(atlas, layout).to(dtype).contiguous()
    _check_fwd(layout, quad, loop_points(cfg, 300, dev, seed=4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,c_dim", [
    ([0.48], 8), ([0.48, 0.24], 32), ([0.48, 0.24, 0.12], 8),
    ([0.48, 0.24, 0.12, 0.06], 8), ([0.48, 0.24], 64)])
def test_fwd_kernels_levels_and_widths(dev, res, c_dim, dtype):
    """1-4 levels, and rows wider than 128 channels (two passes of the
    warp, each with its own held rows)."""
    layout = make_layout(BOUND, res, c_dim)
    rng = np.random.default_rng(16)
    atlas = torch.tensor(rng.normal(size=(layout.total_rows, c_dim)),
                         dtype=torch.float32, device=dev)
    quad = pack_quad(atlas, layout).to(dtype).contiguous()
    p = torch.tensor(rng.uniform(-1.05, 1.05, size=(999, 3)),
                     dtype=torch.float32, device=dev)
    _check_fwd(layout, quad, p)


@pytest.mark.cuda
def test_fwd_entries_refuse_a_bad_plan_or_table(dev):
    """The C entries return cudaErrorInvalidValue (1) for a run longer
    than a tile, a block with no run, a plan that leaves points out, or
    plane axes other than the orientation's; the wrapper's own plan and
    table pass."""
    layout = make_layout(BOUND, [0.48, 0.24], C_DIM)
    quad = torch.zeros((layout.total_rows, 4 * C_DIM), device=dev)
    n = 100
    p = torch.zeros((n, 3), device=dev)
    out = torch.empty((n, 2 * 4 * C_DIM), device=dev)
    lib = cuda_sample.load()
    good = cuda_sample._plane_table(layout)
    bad = (ctypes.c_int * len(good))(*good)
    bad[3], bad[4] = bad[4], bad[3]  # plane 0's axes swapped
    stream = torch.cuda.current_stream(dev).cuda_stream

    def k1(table, run, warps, blocks):
        return lib.plane_sample_fwd(
            p.data_ptr(), quad.data_ptr(), 0, out.data_ptr(), n,
            4 * C_DIM, 2, ctypes.cast(table, ctypes.c_void_p), run, warps,
            blocks, stream)

    run, warps, blocks = cuda_sample.fwd_launch_plan(n)
    assert k1(good, run, warps, blocks) == 0
    assert k1(bad, run, warps, blocks) == 1
    assert k1(good, 33, warps, 1) == 1  # a run longer than a tile
    assert k1(good, run, warps, blocks + 1) == 1  # an empty block
    assert k1(good, run, warps, blocks - 1) == 1  # points left out
    assert k1(good, run, warps + 1, blocks) == 1  # not the kernel's block
    info = (ctypes.c_int * 3)()
    rows = smem_sample.coarse_rows(layout)
    assert lib.plane_sample_fwd_smem(
        p.data_ptr(), quad.data_ptr(), 0, out.data_ptr(), n, 4 * C_DIM, 2,
        ctypes.cast(bad, ctypes.c_void_p), rows, 1, rows,
        smem_sample.SMEM_RUN, ctypes.addressof(info), stream) == 1
    torch.cuda.synchronize()


# -- the meshing path ----------------------------------------------------------


def _room(c_dim=32):
    cfg = load_config("configs/Synthetic/room.yaml", DEFAULT_CONFIG)
    cfg["model"]["c_dim"] = c_dim
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["first", "middle", "last"])
def test_k1_on_grid_ordered_volume_chunks(dev, which):
    """K1 at the meshing path's call: whole x-rows of the final SDF
    volume of room.yaml (420,000 points, z fastest; the first chunk lies
    past the bound's edge, the last is 2 rows), bf16 quad of the SDF
    atlas."""
    from myslam_torch.core.geometry import normalize_3d_coordinate
    from myslam_torch.models.planes import compute_bound
    from myslam_torch.utils.mesher import Mesher

    cfg = _room()
    layout = layouts(cfg)["sdf"]
    mesher = Mesher(cfg, scene=None, cam=None)
    chunks = mesher.volume_chunks()
    assert len(chunks) == 113 and chunks[0] == (0, 4)
    x0, x1 = {"first": chunks[0], "middle": chunks[56],
              "last": chunks[-1]}[which]
    bound = torch.tensor(compute_bound(cfg), dtype=torch.float32,
                         device=dev)
    p = normalize_3d_coordinate(mesher.chunk_points(x0, x1, dev), bound)
    assert p.shape == ((x1 - x0) * 350 * 300, 3)
    rng = np.random.default_rng(17)
    atlas = torch.tensor(0.01 * rng.normal(size=(layout.total_rows, 32)),
                         dtype=torch.float32, device=dev)
    quad = pack_quad(atlas, layout).to(torch.bfloat16).contiguous()
    before = cuda_sample.LAUNCHES["plane_sample_fwd"]
    out = cuda_sample.plane_sample_fwd(quad, layout, p)
    torch.cuda.synchronize()
    assert cuda_sample.LAUNCHES["plane_sample_fwd"] == before + 1
    _assert_within(out, cuda_sample.plane_sample_fwd_ref(quad, layout, p),
                   f"K1 on volume chunk {which}")


@pytest.mark.cuda
def test_k1_on_an_image_renderer_chunk(dev):
    """K1 at the full-frame image renderer's fine samples: one chunk of
    40,960 rays of room.yaml's frame 0 at all 40 samples (1,638,400
    ray-ordered points), f32 quad of the SDF atlas at c_dim 32."""
    cfg = _room()
    layout = layouts(cfg)["sdf"]
    p = loop_points(cfg, 40960, dev, seed=5)
    assert p.shape == (1_638_400, 3)
    rng = np.random.default_rng(19)
    atlas = torch.tensor(0.01 * rng.normal(size=(layout.total_rows, 32)),
                         dtype=torch.float32, device=dev)
    quad = pack_quad(atlas, layout).contiguous()
    before = cuda_sample.LAUNCHES["plane_sample_fwd"]
    out = cuda_sample.plane_sample_fwd(quad, layout, p)
    torch.cuda.synchronize()
    assert cuda_sample.LAUNCHES["plane_sample_fwd"] == before + 1
    _assert_within(out, cuda_sample.plane_sample_fwd_ref(quad, layout, p),
                   "K1 on an image chunk")


class _DeviceDraws:
    """A replayed draw source whose draws land on ``dev``."""

    def __init__(self, draws, dev):
        self.draws, self.dev = draws, dev

    def uniform(self, shape):
        return self.draws.uniform(shape).to(self.dev)


@pytest.mark.cuda
def test_image_renderer_on_the_card_matches_the_cpu(dev):
    """make_image_renderer at 24x32 in chunks of 200 rays (4 chunks, 32
    pad rays; depth holes take the coarse pass) on the card, through K1
    three times per chunk, against the CPU's plain path on the same map
    and draws."""
    from myslam_torch.core.sampling import ReplayDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.models.config import get_model
    from myslam_torch.models.planes import init_map_state
    from myslam_torch.render.renderer import make_image_renderer, \
        scene_from_cfg

    cfg = _room(c_dim=C_DIM)
    cfg["cam"].update(H=24, W=32, fx=20.0, fy=20.0, cx=15.5, cy=11.5)
    cfg["planes_res"].update(coarse=0.48, fine=0.24)
    cfg["c_planes_res"].update(coarse=0.48, fine=0.12)
    cfg["rendering"]["perturb"] = False
    cam, scene = Camera.from_cfg(cfg), scene_from_cfg(cfg)
    rng = np.random.default_rng(23)
    depth = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
    depth[::3, ::4] = 0.0
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [2.0, 1.5, 1.2]
    pdf = [rng.uniform(size=(200, scene.n_importance)).astype(np.float32)
           for _ in range(4)]
    out = {}
    for where in ("cpu", dev):
        gen = torch.Generator().manual_seed(3)
        ms = init_map_state(gen, scene.sdf_layout, scene.color_layout,
                            get_model(cfg, gen), std=0.1, device=where)
        render = make_image_renderer(scene, cam, ray_batch_size=200)
        before = cuda_sample.LAUNCHES["plane_sample_fwd"]
        d, c = render(ms, torch.tensor(c2w, device=where),
                      torch.tensor(depth, device=where),
                      _DeviceDraws(ReplayDraws(pdf), where))
        out[str(where)] = (d.cpu(), c.cpu())
        launched = cuda_sample.LAUNCHES["plane_sample_fwd"] - before
        assert launched == (12 if where == dev else 0)
    (dc, cc), (dg, cg) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(dg, dc, atol=1e-4, rtol=0)
    torch.testing.assert_close(cg, cc, atol=1e-4, rtol=0)


def _sphere_volume(n, r=0.6):
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    return np.linalg.norm(g, axis=-1) - r


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sphere", "random", "room_gt"])
@pytest.mark.parametrize("slab_cells", [2_000_000, 3_000])
def test_marching_on_the_card_matches_the_cpu(dev, case, slab_cells):
    """Counts, vertices and faces bit for bit."""
    from myslam_torch.ops.marching import extract_isosurface_device
    from myslam_torch.utils.datasets import get_dataset

    if case == "sphere":
        vol = _sphere_volume(48)
    elif case == "random":
        vol = np.random.default_rng(18).normal(
            size=(30, 21, 26)).astype(np.float32)
    else:
        ds = get_dataset(_room())
        axes = [np.arange(lo - 0.05, hi + 0.1, 0.05, dtype=np.float32)
                for lo, hi in ds.room]
        g = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
        vol = ds.gt_sdf(g.reshape(-1, 3)).reshape(g.shape[:-1])
    v_cpu, f_cpu = extract_isosurface_device(torch.tensor(vol),
                                             slab_cells=slab_cells)
    v, f = extract_isosurface_device(torch.tensor(vol, device=dev),
                                     slab_cells=slab_cells)
    assert v.device.type == dev.type and len(f_cpu) > 1000
    assert torch.equal(v.cpu(), v_cpu) and torch.equal(f.cpu(), f_cpu)


def _sphere_tris():
    from myslam_torch.ops.marching import extract_isosurface
    from myslam_torch.utils.meshmath import subdivide_to_edge

    v, f = extract_isosurface(_sphere_volume(40), [-1, -1, -1],
                              [2 / 39] * 3, device="cpu")
    v, f = subdivide_to_edge(v, f, 0.03)
    return v[f]


@pytest.mark.cuda
def test_rasterizer_on_the_card_matches_the_cpu(dev):
    from myslam_torch.tools.eval_recon import _viewmatrix
    from myslam_torch.utils.meshmath import make_depth_rasterizer

    tris = _sphere_tris()
    for origin in ([-0.6, 0.4, -2.2], [0.1, 0.2, 0.0]):  # outside, inside
        c2w = _viewmatrix(np.array([0.3, -0.2, 1.0]),
                          np.array([0.0, 1.0, 0.0]), np.array(origin))
        w2c = np.linalg.inv(c2w)
        args = (96, 128, 90.0, 90.0, 63.5, 47.5)
        cpu = make_depth_rasterizer(*args, chunk=4096, device="cpu")(tris,
                                                                     w2c)
        card = make_depth_rasterizer(*args, chunk=4096, device=dev)(tris,
                                                                    w2c)
        assert (cpu > 0).mean() > 0.1
        np.testing.assert_array_equal(card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("eval_rec", [False, True])
def test_vertex_visibility_on_the_card_matches_the_cpu(dev, tmp_path,
                                                       eval_rec):
    from myslam_torch.tools.cull_mesh import vertex_visibility
    from myslam_torch.utils.datasets import get_dataset
    from myslam_torch.utils.ply import read_ply

    cfg = _room()
    cfg["cam"].update(H=48, W=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5)
    cfg["data"]["n_frames"] = 20
    cfg["meshing"]["eval_rec"] = eval_rec
    ds = get_dataset(cfg)
    path = str(tmp_path / "gt.ply")
    ds.save_gt_mesh(path, resolution=0.08, device=dev)
    verts = read_ply(path)[0]
    frames = [ds.get_frame(i)[1:] for i in range(len(ds))]
    cpu = vertex_visibility(verts, cfg, iter(frames), device="cpu")
    card = vertex_visibility(verts, cfg, iter(frames), device=dev)
    assert 0.05 < cpu.mean() < 0.95
    np.testing.assert_array_equal(card, cpu)


@pytest.mark.cuda
def test_packed_gather_on_the_card_matches_the_cpu(dev):
    """The packed store's pixel reads (uint8 color, uint16 depth read
    through its int16 view, times the ray's keyframe scale), as the
    mapper's loss makes them: equal bit for bit on the card and the CPU,
    depths past 32767 included."""
    from myslam_torch.ops.pixel_gather import gather_rgb, gather_u16

    rng = np.random.default_rng(11)
    cap, H, W, R = 5, 48, 64, 4000
    colors = rng.integers(0, 256, (cap, H, W, 3), np.uint8)
    depths = rng.integers(0, 65536, (cap, H, W), np.uint16)
    inv_q = rng.uniform(1e-5, 1e-3, cap).astype(np.float32)
    kf = rng.integers(0, cap, R)
    flat = kf * H * W + rng.integers(0, H * W, R)
    out = {}
    for d in (torch.device("cpu"), dev):
        c = torch.from_numpy(colors).to(d)
        u16 = torch.from_numpy(depths).to(d)
        q = torch.from_numpy(inv_q).to(d)
        f = torch.from_numpy(flat).to(d)
        k = torch.from_numpy(kf).to(d)
        raw = gather_u16(u16, f)
        out[d.type] = (raw.cpu(),
                       (raw.to(torch.float32) * q[k]).cpu(),
                       (gather_rgb(c, f).to(torch.float32)
                        * (1.0 / 255.0)).cpu())
    assert out["cuda"][0].dtype == torch.int32
    np.testing.assert_array_equal(out["cpu"][0].numpy(),
                                  depths.reshape(-1)[flat].astype(np.int64))
    assert int(out["cpu"][0].max()) > 32767
    for got, ref in zip(out["cuda"], out["cpu"]):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_stage_lines_on_the_card_uploads_the_evicted_slot(dev):
    """A host-staged store on the card: pinned host imagery; a window that
    evicts the least recently used line uploads exactly the host imagery
    of its new slot; the scratch line binds to a free line."""
    from myslam_torch.engine.camera import Camera
    from myslam_torch.engine.keyframes import KeyframeStore

    cam = Camera(H=48, W=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5)
    st = KeyframeStore(8, cam, dev, mode="host_staged")
    assert st.colors_u8.is_pinned() and st.depths_u16.is_pinned()
    st.init_cache(4)  # 3 usable lines + scratch
    assert st.cache_depths.device.type == "cuda"
    rng = np.random.default_rng(12)

    def frame():
        return (rng.integers(0, 256, (48, 64, 3), np.uint8),
                rng.integers(0, 65536, (48, 64), np.uint16))

    for s in range(5):
        st.add_host(s, *frame(), 1e-3 * (s + 1))
    st.stage_lines([0, 1, 2])
    (ln,) = st.stage_lines([3])  # evicts slot 0's line
    torch.cuda.synchronize()
    assert st.cache_misses == 4 and st.line_of_slot[0] == -1
    assert st.slot_of_line[ln] == 3
    assert torch.equal(st.cache_colors[ln].cpu(), st.colors_u8[3])
    assert torch.equal(st.cache_depths[ln].cpu(), st.depths_u16[3])
    assert float(st.cache_inv_q[ln]) == float(st.depth_inv_q[3])
    c, d = frame()
    st.stage_scratch(torch.from_numpy(c), torch.from_numpy(d), 7e-3)
    pos = st.add_host(99, c, d, 7e-3)
    st.bind_scratch(pos)
    ln = int(st.line_of_slot[pos])
    torch.cuda.synchronize()
    assert ln != st.scratch_line
    np.testing.assert_array_equal(st.cache_colors[ln].cpu().numpy(), c)
    np.testing.assert_array_equal(st.cache_depths[ln].cpu().numpy(), d)


def _packet(rng, idx, H=96, W=128, iters=6, n_px=5000):
    """A full FramePacket of random content, its numpy arrays kept."""
    from myslam_torch.utils.datasets import STAGED_FIELDS, FramePacket

    pkt = FramePacket(
        idx, np.eye(4, dtype=np.float32),
        rng.integers(0, W, (iters, n_px)).astype(np.uint16),
        rng.integers(0, H, (iters, n_px)).astype(np.uint16),
        rng.integers(0, 256, (iters, n_px, 3), np.uint8),
        rng.uniform(0, 5, (iters, n_px)).astype(np.float32),
        rng.integers(0, 256, (H, W, 3), np.uint8),
        rng.integers(0, 65536, (H, W), np.uint16), 1e-4, True)
    return pkt, {k: getattr(pkt, k) for k in STAGED_FIELDS}


def _assert_staged(pkt, ref):
    from myslam_torch.utils.datasets import wait_staged

    wait_staged(pkt)
    assert pkt.ready is None
    for name, arr in ref.items():
        got = getattr(pkt, name)
        assert got.device.type == "cuda" and got.shape == arr.shape
        np.testing.assert_array_equal(got.cpu().numpy(), arr)
    np.testing.assert_array_equal(pkt.imagery_host()[0], ref["color_u8"])
    np.testing.assert_array_equal(pkt.imagery_host()[1], ref["depth_u16"])


@pytest.mark.cuda
def test_staged_packet_equals_its_numpy_packet(dev):
    """stage_packet's uploads, once the consumer's stream waits on their
    event, hold the packet's numpy arrays byte for byte (uint16 pixel
    coordinates and depths included), and the host imagery stays."""
    from myslam_torch.utils.datasets import PinnedRing, build_packet, \
        stage_packet, Synthetic

    cfg = {"dataset": "synthetic", "data": {"n_frames": 2},
           "cam": {"H": 48, "W": 64, "fx": 40.0, "fy": 40.0, "cx": 31.5,
                   "cy": 23.5}}
    pkt = build_packet(Synthetic(cfg), 1, iters=4, n_px=300, ie_h=2, ie_w=2,
                       need_full=True)
    ref = {k: getattr(pkt, k) for k in ("px_i", "px_j", "px_color",
                                        "px_depth", "color_u8", "depth_u16")}
    _assert_staged(stage_packet(pkt, PinnedRing(dev, 2)), ref)


@pytest.mark.cuda
def test_pinned_ring_survives_more_packets_in_flight_than_slots(dev):
    """Twelve packets staged through a ring of two slots before any is
    consumed: every slot is refilled only after its previous copy has
    completed, so each packet arrives intact; the ring allocates its
    pinned buffers once per slot and field."""
    from myslam_torch.utils.datasets import PinnedRing, STAGED_FIELDS, \
        stage_packet

    rng = np.random.default_rng(21)
    ring = PinnedRing(dev, 2)
    staged = []
    for idx in range(12):
        pkt, ref = _packet(rng, idx)
        staged.append((stage_packet(pkt, ring), ref))
    for pkt, ref in staged:
        _assert_staged(pkt, ref)
    assert ring.allocations == 2 * len(STAGED_FIELDS)


@pytest.mark.cuda
def test_codec_round_trips_on_this_host(dev):
    """The codec builds and runs on the card's host: PNG round trips byte
    for byte, the JPEG one at quality 95 within OpenCV's error on the
    same 680x1200 render (chip_smoke.JPEG_Q95_*)."""
    import chip_smoke
    from myslam_torch.utils import imageio
    from myslam_torch.utils.datasets import Synthetic

    cfg = load_config("configs/Synthetic/room.yaml", DEFAULT_CONFIG)
    color, depth, _ = Synthetic(cfg).get_frame(0)
    rgb = (np.clip(color, 0, 1) * 255).astype(np.uint8)
    d16 = np.clip(depth * 6553.5, 0, 65535).astype(np.uint16)
    for img in (rgb, d16, rgb[..., 0]):
        np.testing.assert_array_equal(
            imageio.read_png(imageio.encode_png(img)), img)
    err = np.abs(imageio.read_jpeg(imageio.encode_jpeg(rgb, 95)).astype(
        np.int64) - rgb)
    assert err.max() <= chip_smoke.JPEG_Q95_MAX_ERR
    assert err.mean() <= chip_smoke.JPEG_Q95_MEAN_ERR


@pytest.mark.cuda
def test_replayed_tracker_matches_the_eager_one(dev, monkeypatch):
    """The group tracker's replayed iterations (``engine/tracker.py``)
    against its eager ones on the card, over two groups of two frames with
    the atlases and decoders changed in place between them, as a mapping
    step changes them: losses within the benchmark's ``track_loss_gap``,
    each iteration's pose within ``track_step_gap`` of that iteration's
    step (``slambench/limits/replica_dense.json``); K1/K2 launches per
    group equal to the eager path's; one capture for both groups (its
    frame's first iterations run eagerly), and another for a changed
    pixel count."""
    import json

    from myslam_torch.core.sampling import TorchDraws
    from myslam_torch.engine import tracker
    from test_torch_track_graph import ITERS, _frames, _setup

    with open("slambench/limits/replica_dense.json") as f:
        limits = json.load(f)["limits"]
    cfg, scene, cam, ms = _setup()
    for name in ("sdf_atlas", "color_atlas"):
        setattr(ms, name, getattr(ms, name).detach().to(dev)
                .requires_grad_())
    ms.decoder.to(dev)
    start = [p.detach().clone() for p in
             (ms.sdf_atlas, ms.color_atlas, *ms.decoder.parameters())]
    frames = _frames(cam) * 2
    est0 = torch.eye(4, device=dev).repeat(8, 1, 1)
    est0[:, 2, 3] = -0.6 + 0.01 * torch.arange(8, device=dev)

    def stack(k, g):
        return torch.stack([f[k].to(dev) for f in frames[2 * g:2 * g + 2]])

    def run(n_px=None):
        with torch.no_grad():
            for p, s in zip((ms.sdf_atlas, ms.color_atlas,
                             *ms.decoder.parameters()), start):
                p.copy_(s)
        group = tracker.make_group_tracker(cfg, scene, cam)
        est = est0.clone()
        draws = TorchDraws(11, dev)
        outs, launches = [], []
        for g in range(2):
            before = sum(cuda_sample.LAUNCHES[k] for k in
                         ("plane_sample_fwd", "plane_sample_bwd"))
            px = [stack(k, g)[:, :, :n_px] for k in (1, 2, 3, 4)]
            outs.append(group(ms, est, 2 + 2 * g, *px, draws))
            torch.cuda.synchronize()
            launches.append(sum(cuda_sample.LAUNCHES[k] for k in
                                ("plane_sample_fwd", "plane_sample_bwd"))
                            - before)
            with torch.no_grad():  # a mapping step, in place
                ms.sdf_atlas.mul_(1.05).add_(0.01)
                ms.color_atlas.mul_(0.95)
                for p in ms.decoder.parameters():
                    p.mul_(1.02)
        return outs, launches, est

    counts0 = dict(tracker.GRAPH_COUNTS)
    graph, graph_launches, graph_est = run()
    counts1 = dict(tracker.GRAPH_COUNTS)
    warm = min(tracker.WARMUP_ITERS, ITERS)
    assert counts1["captures"] - counts0["captures"] == 1
    assert counts1["replays"] - counts0["replays"] == 4 * ITERS - warm
    assert counts1["eager_iters"] - counts0["eager_iters"] == warm

    own = cuda_sample.plane_sample_fwd
    monkeypatch.setattr(cuda_sample, "plane_sample_fwd",
                        lambda *a, **k: own(*a, **k))
    eager, eager_launches, eager_est = run()
    monkeypatch.undo()
    counts2 = dict(tracker.GRAPH_COUNTS)
    assert counts2["eager_iters"] - counts1["eager_iters"] == 4 * ITERS
    assert counts2["replays"] == counts1["replays"]

    assert graph_launches == eager_launches == [2 * ITERS * 4] * 2
    for (_, gf, gb, gp), (_, ef, eb, ep) in zip(graph, eager):
        for got, want in ((gf, ef), (gb, eb)):
            gap = ((got - want).abs() / want.abs()).max()
            assert float(gap) <= limits["track_loss_gap"]
        steps = (ep[:, 1:] - ep[:, :-1]).norm(dim=-1)
        gaps = (gp[:, 1:] - ep[:, 1:]).norm(dim=-1) / steps.clamp(
            min=float(steps.median()))
        assert float(gaps.max()) <= limits["track_step_gap"]
    torch.testing.assert_close(graph_est, eager_est, rtol=0, atol=1e-4)

    # A changed pixel count captures again.
    run(n_px=48)
    assert tracker.GRAPH_COUNTS["captures"] - counts2["captures"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 40), (7, 1), (2, 3, 8)])
def test_cumprod_positive_matches_torch_bit_for_bit_on_the_card(dev, shape):
    """Compositing's cumulative product (``ops/composite.py``, mapping's
    and tracking's) against ``torch.cumprod`` on the card: the same
    values and gradients, bit for bit."""
    from test_torch_track_graph import check_cumprod_positive

    check_cumprod_positive(shape, dev)


def map_three_frames(dev, importance, packed, replay, iters=15, seed=13):
    """Three mapped frames of ``iters`` iterations each on the card,
    replayed (``replay``) or with the body run eagerly, the third after
    the SDF atlas is replaced.  Each replayed iteration is followed from
    its own state, as the benchmark's check follows the program: before
    its step the body runs eagerly at the same map and poses on the
    iteration's draws as they were drawn (not the graph's slots), and
    Adam's step is taken once with those gradients and once, for real,
    with the replay's ``.grad``, from the same state.  Returns, per
    frame, the losses, the loss gap and step gap of each followed
    iteration (``map_loss_gap`` and ``map_steps_gap`` as
    ``slambench/check.py`` measures them) and the K1/K2 launches of the
    frame's own iterations; and the trajectory."""
    import copy

    from myslam_torch.core.sampling import TorchDraws
    from myslam_torch.engine import mapper
    from slambench.check import leaf_gaps, rel
    from test_torch_map_graph import Recording, setup_case

    make = mapper.make_map_optimizer
    kernels = ("plane_sample_fwd", "plane_sample_bwd")
    made, frames = [], []
    init = mapper.StaticMap.__init__

    def noting_init(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    class Drawn:
        """One iteration's recorded draws, served in order."""

        def __init__(self, kept):
            self.kept = list(kept)

        def _take(self, kind, shape):
            got, t = self.kept.pop(0)
            assert got == kind and tuple(t.shape) == tuple(shape)
            return t

        def uniform(self, shape):
            return self._take("uniform", shape)

        def randint(self, shape, low, high):
            return self._take("randint", shape)

    def wrapped(cfg, ms, poses, lr_factor):
        opt = make(cfg, ms, poses, lr_factor)
        params = mapper.optimizer_params(opt)
        st = made[-1]
        rec = {"loss_gaps": [], "step_gaps": [], "extra": 0}
        step = opt.step

        def follow():
            if st.graph is None:  # an eager iteration: nothing to follow
                return step()
            k = int(st.it) - 1
            before = sum(cuda_sample.LAUNCHES[n] for n in kernels)
            drawn = Drawn(draws.kept[-len(st.schedule):])
            loss = st.loss_fn(ms, st.poses, st.pose_mask, st.lines,
                              st.n_slots, *st.imagery, drawn)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            rec["extra"] += sum(cuda_sample.LAUNCHES[n]
                                for n in kernels) - before
            live = [n for n, g in enumerate(grads) if g is not None]
            start = [p.detach().clone() for p in params]
            state = copy.deepcopy(opt.state_dict())
            replayed = [p.grad for p in params]
            for p, g in zip(params, grads):
                p.grad = g
            step()
            ref = [p.detach().clone() for p in params]
            with torch.no_grad():
                for p, x in zip(params, start):
                    p.copy_(x)
            opt.load_state_dict(state)
            for p, g in zip(params, replayed):
                p.grad = g
            step()
            rec["loss_gaps"].append(rel(float(st.losses[k]),
                                        float(loss.detach())))
            rec["step_gaps"].append(leaf_gaps(
                {n: params[n].detach() for n in live},
                {n: ref[n] for n in live}, {n: start[n] for n in live},
                {n: grads[n] for n in live}))

        opt.step = follow
        frames.append(rec)
        return opt

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mapper, "make_map_optimizer", wrapped)
        mp.setattr(mapper.StaticMap, "__init__", noting_init)
        if not replay:
            mp.setattr(mapper, "replayable", lambda *a, **k: False)
        map_frame, ms, store, est, args = setup_case(
            dev, importance, packed, n_rays=2048, iters=iters)
        draws = Recording(TorchDraws(seed, dev))
        for f in range(3):
            if f == 2:
                ms.sdf_atlas = ms.sdf_atlas.detach().clone().requires_grad_()
            before = sum(cuda_sample.LAUNCHES[k] for k in kernels)
            losses = map_frame(ms, store, est, *args, draws, iters=iters,
                               lr_factor=1.0, joint_opt=True, admit=False)
            torch.cuda.synchronize()
            frames[f]["losses"] = losses.clone()
            frames[f]["launches"] = sum(cuda_sample.LAUNCHES[k] for k in
                                        kernels) - before - frames[f]["extra"]
    return frames, est.clone()


@pytest.mark.cuda
@pytest.mark.parametrize("importance,packed", [(False, False), (True, True)])
def test_replayed_mapper_matches_the_eager_one(dev, importance, packed):
    """The frame mapper's replayed iterations (``engine/mapper.py``)
    against the same body run eagerly on the card
    (``map_three_frames``): two mapped frames of 15 iterations each,
    then a third after the SDF atlas is replaced.  Every replayed
    iteration, followed from its own state, within ``replica_dense``'s
    ``map_loss_gap`` and ``map_steps_gap`` (``slambench/limits/``);
    K1/K2 launches per frame equal to the eager path's; one capture for
    the first two frames (its frame's first iterations run eagerly),
    another for the replaced atlas.  Float store without the importance
    branch, as ``replica_dense`` maps, and packed store with it, as
    ``tum_holes``.  Two runs are not compared with each other: K2's
    atomics part them, and the importance branch's sort turns that into
    step gaps up to 0.5 within 45 iterations, eager against eager."""
    import json

    from myslam_torch.engine import mapper

    with open("slambench/limits/replica_dense.json") as f:
        limits = json.load(f)["limits"]
    iters = 15
    counts0 = dict(mapper.GRAPH_COUNTS)
    graph, _ = map_three_frames(dev, importance, packed, True, iters)
    counts1 = dict(mapper.GRAPH_COUNTS)
    warm = min(mapper.WARMUP_ITERS, iters)
    assert counts1["captures"] - counts0["captures"] == 2
    assert counts1["replays"] - counts0["replays"] == 3 * iters - 2 * warm
    assert counts1["eager_iters"] - counts0["eager_iters"] == 2 * warm
    eager, _ = map_three_frames(dev, importance, packed, False, iters)
    counts2 = dict(mapper.GRAPH_COUNTS)
    assert counts2["eager_iters"] - counts1["eager_iters"] == 3 * iters
    assert counts2["replays"] == counts1["replays"]

    per_iter = 2 * 2 + (1 if importance else 0)
    followed = [len(g["step_gaps"]) for g in graph]
    assert followed == [iters - warm, iters, iters - warm]
    for g, e in zip(graph, eager):
        assert g["launches"] == e["launches"] == per_iter * iters
        assert not e["step_gaps"]
        assert max(g["loss_gaps"]) <= limits["map_loss_gap"]
        assert max(g["step_gaps"]) <= limits["map_steps_gap"]
