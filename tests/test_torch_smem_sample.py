"""The port's shared-memory sample (ops/smem_sample.py, kernel K3's
module) against the JAX package's Pallas B2/B3 glue.

  * ``plane_indices_and_fracs`` against the JAX function on the same
    numpy points, including points past +-1 and exactly on the border:
    row indices equal, fractions within atol 1e-6;
  * ``sample_fused_smem`` (the plain version on the CPU, on the quad cast
    to bfloat16) against B2 ``make_sample_quad_pallas_vmem`` with its
    default bfloat16 atlas and against B3 ``sample_fused_pallas``, both
    in interpret mode: atol 1e-5 (the same bfloat16 rows weighted in
    float32 on both sides);
  * the cluster planner on the synthetic room and room0-scale layouts;
  * dispatch: a CUDA-typed call never reaches the plain version.

K3 itself runs only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myslam_tpu.models.planes import make_layout as j_make_layout
from myslam_tpu.ops.plane_sample import pack_quad as j_pack_quad
from myslam_torch.models.planes import compute_bound, make_layout
from myslam_torch.ops import cuda_sample, smem_sample
from myslam_torch.ops.plane_sample import pack_quad
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

torch.set_num_threads(2)  # several test workers share the CPU

BOUND = np.array([[-1.9, 7.94], [-2.2, 4.52], [-2.5, 2.54]], np.float32)
ROOM0_BOUND = np.array([[-1.9, 8.18], [-2.2, 4.58], [-2.5, 2.78]],
                       np.float32)
C_DIM = 8
N_PTS = 300


def _points(seed, n=N_PTS):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.05, 1.05, size=(n, 3)).astype(np.float32)
    # Exactly on the border and just past it, on every axis.
    p[:4] = np.array([[-1.0, 1.0, -1.0], [1.0, -1.0, 1.0],
                      [-1.05, 1.05, 0.0], [1.0, 1.0, 1.0]], np.float32)
    return p


def test_plane_indices_and_fracs_match_jax():
    from myslam_tpu.ops.pallas_sample import plane_indices_and_fracs

    layout = make_layout(BOUND, [0.48, 0.24], C_DIM)
    jlayout = j_make_layout(jnp.asarray(BOUND), [0.48, 0.24], C_DIM)
    p = _points(0)
    idx, wx, wy = smem_sample.plane_indices_and_fracs(layout,
                                                      torch.tensor(p))
    jidx, jwx, jwy = plane_indices_and_fracs(jlayout, jnp.asarray(p))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(wx.numpy(), np.asarray(jwx), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(wy.numpy(), np.asarray(jwy), atol=1e-6,
                               rtol=0)


@pytest.fixture
def _pallas_interpret(monkeypatch):
    pallas_sample = pytest.importorskip("myslam_tpu.ops.pallas_sample")
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pallas_sample.pl, "pallas_call", interp)
    return pallas_sample


@pytest.mark.parametrize("variant", ["b2_vmem_bf16", "b3_sample_fused"])
def test_sample_fused_smem_matches_pallas(variant, _pallas_interpret):
    ps = _pallas_interpret
    layout = make_layout(BOUND, [0.48, 0.24], C_DIM)
    jlayout = j_make_layout(jnp.asarray(BOUND), [0.48, 0.24], C_DIM)
    rng = np.random.default_rng(1)
    atlas = rng.normal(size=(layout.total_rows, C_DIM)).astype(np.float32)
    p = _points(2)
    jquad = j_pack_quad(jnp.asarray(atlas), jlayout)
    if variant == "b2_vmem_bf16":
        idx, wx, wy = ps.plane_indices_and_fracs(jlayout, jnp.asarray(p))
        fn = ps.make_sample_quad_pallas_vmem(jlayout, N_PTS, tile=128)
        ref = np.asarray(fn(jquad, idx, wx, wy))
    else:
        ref = np.asarray(ps.sample_fused_pallas(jquad, jlayout,
                                                jnp.asarray(p), tile=128))
    got = smem_sample.sample_fused_smem(
        pack_quad(torch.tensor(atlas), layout), layout, torch.tensor(p))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    # The bfloat16 cast matters: the f32 quad gives another answer.
    f32 = cuda_sample.plane_sample_fwd_ref(
        pack_quad(torch.tensor(atlas), layout), layout, torch.tensor(p))
    assert float((f32 - got).abs().max()) > 1e-4


def test_coarse_cluster_blocks_plans_the_cluster():
    cfg = load_config("configs/Synthetic/room.yaml", DEFAULT_CONFIG)
    bound = compute_bound(cfg)
    p, q = cfg["planes_res"], cfg["c_planes_res"]
    for res in ([p["coarse"], p["fine"]], [q["coarse"], q["fine"]]):
        layout = make_layout(bound, res, 32)
        assert smem_sample.coarse_rows(layout) == 699
        assert smem_sample.coarse_cluster_blocks(layout, torch.bfloat16) == 1
        assert smem_sample.coarse_cluster_blocks(layout, torch.float32) == 2
    for res in ([0.24, 0.06], [0.24, 0.03]):
        layout = make_layout(ROOM0_BOUND, res, 32)
        assert smem_sample.coarse_cluster_blocks(layout, torch.bfloat16) == 3
        assert smem_sample.coarse_cluster_blocks(layout, torch.float32) == 6
    # 0.12 m coarse planes on room0: 10,625 rows, 2.7 MB in bfloat16.
    big = make_layout(ROOM0_BOUND, [0.12, 0.06], 32)
    nbytes = smem_sample.coarse_rows(big) * 128 * 2
    with pytest.raises(ValueError, match=str(nbytes)):
        smem_sample.coarse_cluster_blocks(big, torch.bfloat16)
    with pytest.raises(ValueError):
        smem_sample.make_sample_quad_smem(big, 10)


def test_cuda_typed_call_never_reaches_the_plain_version(monkeypatch):
    """A tensor off the CPU goes to K3 or raises: here 'meta' tensors (no
    CUDA in this process) must raise before the plain version runs."""
    layout = make_layout(BOUND, [0.48, 0.24], C_DIM)
    calls = []
    orig = cuda_sample.plane_sample_fwd_ref

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(cuda_sample, "plane_sample_fwd_ref", spy)
    quad = torch.zeros((layout.total_rows, 4 * C_DIM), dtype=torch.bfloat16)
    p = torch.tensor(_points(3))
    before = dict(cuda_sample.LAUNCHES)
    with pytest.raises(ValueError):
        smem_sample.plane_sample_fwd_smem(quad.to("meta"), layout,
                                          p.to("meta"))
    with pytest.raises(ValueError):  # mixed devices
        smem_sample.plane_sample_fwd_smem(quad.to("meta"), layout, p)
    with pytest.raises(ValueError):
        smem_sample.make_sample_quad_smem(layout, N_PTS)(
            quad.to("meta"), p.to("meta"))
    assert calls == []
    smem_sample.plane_sample_fwd_smem(quad, layout, p)
    assert calls == [1]
    assert cuda_sample.LAUNCHES == before
