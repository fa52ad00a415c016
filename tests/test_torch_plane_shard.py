"""Banded map shards (``myslam_torch/parallel/plane_shard.py``) against
the JAX package's ``myslam_tpu/parallel/plane_shard.py``.

  * the sharded layout (band heights, offsets, the band-major atlas and
    its index maps) equal to JAX's at 2 and 3 shards, and the round trip
    exact;
  * the banded pack and sample of N shards run in one process (each
    shard's halo taken from the next shard's band, the partial features
    summed by hand) against JAX's ``make_sharded_sampler`` on N virtual
    devices: the features, the atlas gradient and the coordinate
    gradient within 1e-5 of the largest value, with no factor between
    the two (JAX's ``test_sharded_gradients_match`` holds its own banded
    gradients equal to the unsharded ones the same way);
  * the banded plain kernels (the CPU path and the card's oracle) against
    the unbanded plain K1 / K2 on the unsharded atlas: the shards' parts
    sum to the unbanded forward and coordinate gradient, and their quad
    gradients, unsharded, are the unbanded quad gradient.

The gang's halo exchange, sum and coordinate all-reduce are held by
test_torch_sharded_engine.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from myslam_tpu.models.planes import make_layout as jmake_layout
from myslam_tpu.parallel import plane_shard as jps
from myslam_torch.models.planes import make_layout
from myslam_torch.ops import cuda_sample
from myslam_torch.ops.plane_sample import pack_quad, sample_banded
from myslam_torch.parallel import plane_shard as tps

torch.set_num_threads(2)  # several test workers share the CPU

BOUND = [[-1.9, 7.94], [-2.2, 4.52], [-2.5, 2.54]]
C_DIM = 8
RES = [0.24, 0.06]


def layouts():
    return (jmake_layout(jnp.asarray(BOUND), RES, C_DIM),
            make_layout(np.asarray(BOUND, np.float32), RES, C_DIM))


def inputs(layout, n_pts=256):
    rng = np.random.default_rng(0)
    atlas = rng.normal(size=(layout.total_rows, C_DIM)).astype(np.float32)
    # Beyond [-1, 1] too: the border clamp and the zero coordinate
    # gradient outside it.
    p_nor = rng.uniform(-1.1, 1.1, size=(n_pts, 3)).astype(np.float32)
    gbar = rng.normal(size=(n_pts, layout.n_levels * 4 * C_DIM)).astype(
        np.float32)
    return atlas, p_nor, gbar


def close(got, ref, rel=1e-5):
    """Within ``rel`` of the reference's largest value."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("n", [2, 3])
def test_layout_matches_jax(n):
    jl, tl = layouts()
    js, ts = jps.ShardedPlaneLayout(jl, n), tps.ShardedPlaneLayout(tl, n)
    assert ts.band_h == js.band_h and ts.local_off == js.local_off
    assert ts.W == js.W and ts.H == js.H and ts.local_rows == js.local_rows
    atlas, _, _ = inputs(tl)
    sharded = ts.shard_atlas(atlas)
    np.testing.assert_array_equal(sharded, js.shard_atlas(jnp.asarray(atlas)))
    np.testing.assert_array_equal(ts.unshard_atlas(sharded), atlas)
    np.testing.assert_array_equal(ts.to_banded_index(), js.to_banded_index())
    np.testing.assert_array_equal(ts.from_banded_index(),
                                  js.from_banded_index())
    for d in range(n):
        band = ts.band(d)
        assert band.total_rows == ts.local_rows
        assert band.y_lo == tuple(d * bh for bh in js.band_h)


def port_sharded(ts, atlas, p_nor, gbar):
    """N shards in one process: (features, atlas gradient, coordinate
    gradient)."""
    n, rows = ts.n_shards, ts.local_rows
    sharded = torch.as_tensor(ts.shard_atlas(atlas))
    locals_ = [sharded[d * rows:(d + 1) * rows].clone().requires_grad_()
               for d in range(n)]
    p = torch.as_tensor(p_nor).requires_grad_()
    out = 0
    for d in range(n):
        last = d == n - 1
        halo = tps.first_rows(locals_[d if last else d + 1], ts)
        quad = tps.pack_local(locals_[d], halo, ts, last)
        out = out + sample_banded(quad, ts.band(d), p)
    (out * torch.as_tensor(gbar)).sum().backward()
    ga = ts.unshard_atlas(torch.cat([t.grad for t in locals_]).numpy())
    return out.detach().numpy(), ga, p.grad.numpy()


@pytest.mark.parametrize("n", [2, 3])
def test_banded_sample_matches_jax(n):
    jl, tl = layouts()
    js, ts = jps.ShardedPlaneLayout(jl, n), tps.ShardedPlaneLayout(tl, n)
    atlas, p_nor, gbar = inputs(tl)
    mesh = Mesh(np.array(jax.devices()[:n]), ("map",))
    sample = jps.make_sharded_sampler(mesh, "map", js)
    sharded = jax.device_put(js.shard_atlas(jnp.asarray(atlas)),
                             NamedSharding(mesh, P("map", None)))
    ref = np.asarray(jax.jit(sample)(sharded, jnp.asarray(p_nor)))

    def loss(local, p):
        return jnp.sum(sample(local, p) * gbar)

    ga_j, gp_j = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        sharded, jnp.asarray(p_nor))
    feats, ga, gp = port_sharded(ts, atlas, p_nor, gbar)
    close(feats, ref)
    close(ga, js.unshard_atlas(np.asarray(ga_j)))
    close(gp, np.asarray(gp_j))
    assert np.abs(gp).max() > 0 and np.abs(ga).max() > 0


@pytest.mark.parametrize("quad_dtype", [torch.float32, torch.bfloat16])
def test_banded_plain_kernels_sum_to_unbanded(quad_dtype):
    _, tl = layouts()
    atlas, p_nor, gbar = inputs(tl, 512)
    n = 3
    ts = tps.ShardedPlaneLayout(tl, n)
    a = torch.as_tensor(atlas)
    p = torch.as_tensor(p_nor)
    g = torch.as_tensor(gbar)
    quad = pack_quad(a, tl).to(quad_dtype)
    ref = cuda_sample.plane_sample_fwd_ref(quad, tl, p)
    qg_ref, pg_ref = cuda_sample.plane_sample_bwd_ref(g, quad, tl, p)
    rows = ts.local_rows
    sharded = torch.as_tensor(ts.shard_atlas(atlas))
    fwd, pg, qgs = 0, 0, []
    for d in range(n):
        local = sharded[d * rows:(d + 1) * rows]
        last = d == n - 1
        nxt = sharded[(d if last else d + 1) * rows:][:rows]
        q = tps.pack_local(local, tps.first_rows(nxt, ts), ts, last).to(
            quad_dtype)
        band = ts.band(d)
        fwd = fwd + cuda_sample.plane_sample_fwd_banded(q, band, p)
        qg, pgd = cuda_sample.plane_sample_bwd_banded(g, q, band, p)
        pg = pg + pgd
        qgs.append(qg)
    close(fwd.numpy(), ref.numpy(), 1e-6)
    close(pg.numpy(), pg_ref.numpy(), 1e-6)
    # The quad gradient in atlas rows: each band's rows of the unbanded
    # quad gradient (padding rows past a plane's last row get nothing).
    qg_banded = ts.unshard_atlas(torch.cat(qgs).numpy())
    close(qg_banded, qg_ref.numpy(), 1e-6)
    assert all(float(q.abs().sum()) > 0 for q in qgs)
