"""The port's tri-plane sample (ops/plane_sample.py, ops/cuda_sample.py)
against the JAX package.

Forward and both gradients of ``sample_fused`` (through ``pack_quad``)
are held against ``myslam_tpu.ops.plane_sample.sample_fused`` on the same
numpy inputs, with points outside [-1, 1] so the border clamp and its
zero coordinate gradient are exercised.  The JAX side routes every
plane's atlas gradient through its scatter (ONEHOT_MAX_ROWS = 0), since
the one-hot route rounds coarse-plane updates to bfloat16.  The forward
is also held against the Pallas kernels B1 and B2 run in interpret mode.

Tolerance: float32 atol 1e-5 (forward) and 1e-4 (gradients: sums of up
to ~700 products in another order); bfloat16 quads, whose gradient is
rounded to bfloat16 on both sides, within one bfloat16 rounding
(rtol 2^-7).  The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py); here the wrappers take their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.models.planes import make_layout as j_make_layout
from myslam_torch.models.planes import make_layout
from myslam_torch.ops import cuda_sample
from myslam_torch.ops.plane_sample import pack_quad, sample_fused, \
    sample_quad_reduced_ref

torch.set_num_threads(2)  # several test workers share the CPU

BOUND = np.array([[-1.9, 7.94], [-2.2, 4.52], [-2.5, 2.54]], np.float32)
C_DIM = 8
N_PTS = 700


def _inputs(seed):
    layout = make_layout(BOUND, [0.48, 0.24], C_DIM)
    jlayout = j_make_layout(jnp.asarray(BOUND), [0.48, 0.24], C_DIM)
    rng = np.random.default_rng(seed)
    atlas = rng.normal(size=(layout.total_rows, C_DIM)).astype(np.float32)
    p_nor = rng.uniform(-1.05, 1.05, size=(N_PTS, 3)).astype(np.float32)
    gbar = rng.normal(size=(N_PTS, 2 * 4 * C_DIM)).astype(np.float32)
    return layout, jlayout, atlas, p_nor, gbar


def _jax_sample_and_grads(jlayout, atlas, p_nor, gbar, dtype=jnp.float32):
    def f(a, p):
        quad = jps.pack_quad(a, jlayout).astype(dtype)
        return jps.sample_fused(quad, jlayout, p)

    out, vjp = jax.vjp(f, jnp.asarray(atlas), jnp.asarray(p_nor))
    ga, gp = vjp(jnp.asarray(gbar))
    return np.asarray(out), np.asarray(ga), np.asarray(gp)


def _port_sample_and_grads(layout, atlas, p_nor, gbar, dtype=torch.float32):
    a = torch.tensor(atlas, requires_grad=True)
    p = torch.tensor(p_nor, requires_grad=True)
    out = sample_fused(pack_quad(a, layout).to(dtype), layout, p)
    out.backward(torch.tensor(gbar))
    return out.detach().numpy(), a.grad.numpy(), p.grad.numpy()


def test_pack_quad_matches_jax():
    layout, jlayout, atlas, _, _ = _inputs(0)
    np.testing.assert_array_equal(
        pack_quad(torch.tensor(atlas), layout).numpy(),
        np.asarray(jps.pack_quad(jnp.asarray(atlas), jlayout)))


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_forward_and_backward_match_jax(seed, monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)
    layout, jlayout, atlas, p_nor, gbar = _inputs(seed)
    out, ga, gp = _port_sample_and_grads(layout, atlas, p_nor, gbar)
    jout, jga, jgp = _jax_sample_and_grads(jlayout, atlas, p_nor, gbar)
    np.testing.assert_allclose(out, jout, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ga, jga, atol=1e-4, rtol=0)
    np.testing.assert_allclose(gp, jgp, atol=1e-4, rtol=1e-5)
    # Points outside [-1, 1] on an axis get no gradient along it from the
    # clamped planes: some coordinate gradients are exactly zero.
    outside = np.abs(p_nor) > 1.0
    assert outside.any()
    assert np.all(gp[outside.all(axis=1)] == 0.0)


def test_sample_bf16_quad_matches_jax(monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)
    layout, jlayout, atlas, p_nor, gbar = _inputs(2)
    out, ga, gp = _port_sample_and_grads(layout, atlas, p_nor, gbar,
                                         torch.bfloat16)
    jout, jga, jgp = _jax_sample_and_grads(jlayout, atlas, p_nor, gbar,
                                           jnp.bfloat16)
    # Both sides read the same bfloat16 rows and weight them in float32.
    np.testing.assert_allclose(out, jout, atol=1e-5, rtol=0)
    # The quad gradient is rounded to bfloat16 on both sides, so a float32
    # difference at a rounding boundary becomes one bfloat16 step.
    np.testing.assert_allclose(ga, jga, rtol=2.0 ** -7, atol=1e-4)
    np.testing.assert_allclose(gp, jgp, atol=1e-4, rtol=1e-5)


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


@pytest.mark.parametrize("variant", ["dma", "vmem"])
def test_sample_forward_matches_pallas_kernels(variant, _pallas_interpret):
    """K1 replaces Pallas B1 (manual-DMA) and B2 (VMEM-resident) with
    the B3 index math inside: same output on the same inputs."""
    ps = _pallas_interpret
    layout, jlayout, atlas, p_nor, _ = _inputs(3)
    jquad = jps.pack_quad(jnp.asarray(atlas), jlayout)
    idx, wx, wy = ps.plane_indices_and_fracs(jlayout, jnp.asarray(p_nor))
    if variant == "dma":
        fn = ps.make_sample_quad_pallas_dma(jlayout, N_PTS, tile=64)
    else:
        fn = ps.make_sample_quad_pallas_vmem(jlayout, N_PTS, tile=256,
                                             atlas_dtype=jnp.float32)
    ref = np.asarray(fn(jquad, idx, wx, wy))
    got = sample_fused(pack_quad(torch.tensor(atlas), layout), layout,
                       torch.tensor(p_nor)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_frozen_quad_skips_quad_gradient(monkeypatch):
    """Tracking's quads are frozen: the backward is asked for the
    coordinate gradient only, and the quad gets none."""
    layout, _, atlas, p_nor, gbar = _inputs(4)
    asked = []
    orig = cuda_sample.plane_sample_bwd

    def spy(*a, need_quad_grad=True, **k):
        asked.append(need_quad_grad)
        return orig(*a, need_quad_grad=need_quad_grad, **k)

    monkeypatch.setattr(cuda_sample, "plane_sample_bwd", spy)
    quad = pack_quad(torch.tensor(atlas), layout)
    p = torch.tensor(p_nor, requires_grad=True)
    sample_fused(quad, layout, p).backward(torch.tensor(gbar))
    assert asked == [False]
    assert quad.grad is None and p.grad is not None
    _, _, gp = _port_sample_and_grads(layout, atlas, p_nor, gbar)
    np.testing.assert_allclose(p.grad.numpy(), gp, atol=1e-6, rtol=0)


def test_cpu_tensors_take_the_plain_version_without_launching():
    layout, _, atlas, p_nor, gbar = _inputs(5)
    before = dict(cuda_sample.LAUNCHES)
    quad = pack_quad(torch.tensor(atlas), layout)
    out = cuda_sample.plane_sample_fwd(quad, layout, torch.tensor(p_nor))
    np.testing.assert_array_equal(
        out.numpy(),
        sample_quad_reduced_ref(quad, layout, torch.tensor(p_nor)).numpy())
    cuda_sample.plane_sample_bwd(torch.tensor(gbar), quad, layout,
                                 torch.tensor(p_nor))
    assert cuda_sample.LAUNCHES == before


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    """A tensor off the CPU goes to the kernel or raises: here a 'meta'
    tensor (no CUDA in this process) must raise, not be computed."""
    layout, _, atlas, p_nor, gbar = _inputs(6)
    quad = pack_quad(torch.tensor(atlas), layout).to("meta")
    p = torch.tensor(p_nor).to("meta")
    with pytest.raises(ValueError):
        cuda_sample.plane_sample_fwd(quad, layout, p)
    with pytest.raises(ValueError):
        cuda_sample.plane_sample_bwd(torch.tensor(gbar).to("meta"), quad,
                                     layout, p)
    with pytest.raises(ValueError):  # mixed devices
        cuda_sample.plane_sample_fwd(quad, layout, torch.tensor(p_nor))
