"""Banded K2's compaction and the exactness it rests on.

Banded K2 (``ops/cuda_sample.py::plane_sample_bwd_banded``) compacts each
block's chunk of consecutive points to those that own a level of the band
and walks only those, fetching only the owned levels' gbar.  The kernel
runs only on the card (``tests/test_torch_cuda.py``); here:

  (a) its launch plan, indexed as the kernel indexes it, covers every
      point exactly once with no empty block, and the warps' segments of
      a block's list cover every entry once;
  (b) ``cuda_sample.band_lists``, the Python mirror of the in-launch
      compaction (ballot, popcount, scan of the warps' counts), lists
      each owned (point, level) pair exactly once, in point order, as
      ``cuda_sample.band_coords`` counts them;
  (c) skipping is exact: a random gbar and a zero gbar on the (point,
      level) pairs a band does not own give bit-equal outputs of the
      port's plain banded backward (its oracle), and bit-equal JAX
      gradients: of ``sample_local`` on the band, and through
      ``make_sharded_sampler`` on the file's CPU devices, the band's own
      atlas rows (its first rows, the previous band's halo, take that
      band's gradient too).
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
from myslam_torch.parallel import plane_shard as tps
from myslam_torch.tools.bench_sample_bwd import band_quads

torch.set_num_threads(2)  # several test workers share the CPU

BOUND = [[-1.9, 7.94], [-2.2, 4.52], [-2.5, 2.54]]
C_DIM = 8
RES = [0.24, 0.06]
CHUNK, WARPS = cuda_sample.BWD_BANDED_CHUNK, cuda_sample.BWD_BANDED_WARPS


def inputs(n_pts: int, seed: int = 0):
    layout = make_layout(np.asarray(BOUND, np.float32), RES, C_DIM)
    rng = np.random.default_rng(seed)
    atlas = rng.normal(size=(layout.total_rows, C_DIM)).astype(np.float32)
    # Beyond [-1, 1] too: the border clamp.
    p_nor = rng.uniform(-1.1, 1.1, size=(n_pts, 3)).astype(np.float32)
    gbar = rng.normal(size=(n_pts, layout.n_levels * 4 * C_DIM)).astype(
        np.float32)
    return layout, atlas, p_nor, gbar


def owned_levels(band, p_nor: torch.Tensor) -> np.ndarray:
    """(N, L) bool: the point owns a plane of the level on the band."""
    out = np.zeros((p_nor.shape[0], band.n_levels), bool)
    for lvl, _, au, av, H, W, off, y_lo, bh in band.planes():
        out[:, lvl] |= cuda_sample.band_coords(
            p_nor, au, av, H, W, off, y_lo, bh, band.total_rows)[1].numpy()
    return out


@pytest.mark.parametrize("n", [1, CHUNK - 1, CHUNK, CHUNK + 1,
                               3 * CHUNK + 37, 160_000])
def test_banded_launch_plan_covers_every_point_once(n):
    chunk, warps, blocks = cuda_sample.bwd_banded_launch_plan(n)
    assert (chunk, warps) == (CHUNK, WARPS) and chunk == 32 * warps
    seen = np.zeros(n, np.int64)
    for b in range(blocks):
        pts = b * chunk + np.arange(chunk)  # one point per thread
        assert pts[0] < n  # no empty block
        np.add.at(seen, pts[pts < n], 1)
    assert (seen == 1).all()
    # Warp w walks entries [w*len//W, (w+1)*len//W) of its block's list.
    for length in range(chunk + 1):
        cover = np.zeros(length, np.int64)
        for w in range(warps):
            cover[w * length // warps:(w + 1) * length // warps] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize("n_bands", [2, 3])
def test_band_lists_hold_each_owned_pair_once_in_order(n_bands):
    layout, _, p_nor, _ = inputs(5 * CHUNK + 61, seed=n_bands)
    p = torch.as_tensor(p_nor)
    ts = tps.ShardedPlaneLayout(layout, n_bands)
    listed_total = 0
    for d in range(n_bands):
        band = ts.band(d)
        points, masks, lengths = cuda_sample.band_lists(band, p)
        want = owned_levels(band, p)
        got = np.zeros_like(want, np.int64)
        for b, length in enumerate(lengths.tolist()):
            pts = points[b, :length].numpy()
            assert (np.diff(pts) > 0).all()  # point order
            assert ((pts >= b * CHUNK) & (pts < (b + 1) * CHUNK)).all()
            assert (points[b, length:] == -1).all()
            assert (masks[b, length:] == 0).all()
            m = masks[b, :length].numpy()
            assert (m > 0).all()
            for lvl in range(layout.n_levels):
                np.add.at(got[:, lvl], pts[(m >> lvl) & 1 == 1], 1)
        np.testing.assert_array_equal(got, want.astype(np.int64))
        listed_total += int(lengths.sum())
        assert 0 < int(lengths.sum()) < p.shape[0]
    # Every point owns a level on some band.
    assert listed_total >= p.shape[0]


def _unowned_pairs(band, p: torch.Tensor, n_levels: int) -> np.ndarray:
    """(N, L*4C) bool: the gbar entries of (point, level) pairs the band
    does not own."""
    return np.repeat(~owned_levels(band, p), 4 * C_DIM, axis=1).reshape(
        p.shape[0], n_levels * 4 * C_DIM)


@pytest.mark.parametrize("quad_dtype", ["float32", "bfloat16"])
def test_unowned_gbar_changes_nothing(quad_dtype):
    layout, atlas, p_nor, gbar = inputs(400)
    other = np.random.default_rng(1).normal(size=gbar.shape).astype(
        np.float32)
    p = torch.as_tensor(p_nor)
    L = layout.n_levels

    def variants(band):
        """gbar with the band's unowned pairs zero, other values, as is."""
        unowned = _unowned_pairs(band, p, L)
        assert unowned.any() and not unowned.all()
        return [np.where(unowned, 0.0, gbar).astype(np.float32),
                np.where(unowned, other, gbar), gbar]

    # The port's plain banded backward, on every band of 2 and 3.
    tdt = getattr(torch, quad_dtype)
    for n_bands in (2, 3):
        for band, quad in band_quads(layout, torch.as_tensor(atlas),
                                     n_bands, tdt)[1]:
            zero, *rest = [cuda_sample.plane_sample_bwd_banded_ref(
                torch.as_tensor(g), quad, band, p) for g in variants(band)]
            for got in rest:
                for a, b in zip(got, zero):
                    np.testing.assert_array_equal(a.numpy(), b.numpy())
            assert float(zero[0].abs().sum()) > 0
    # JAX on 2 CPU devices: sample_local's VJP on each band's quad, and
    # make_sharded_sampler's atlas gradient on each band's own rows.
    n_bands = 2
    js = jps.ShardedPlaneLayout(jmake_layout(jnp.asarray(BOUND), RES, C_DIM),
                                n_bands)
    jdt = getattr(jnp, quad_dtype)
    mesh = Mesh(np.array(jax.devices()[:n_bands]), ("map",))
    sample = jps.make_sharded_sampler(mesh, "map", js)
    sample_local = jps.make_local_fns(js, "map")[1]
    sharded = jax.device_put(js.shard_atlas(jnp.asarray(atlas, jdt)),
                             NamedSharding(mesh, P("map", None)))
    pj = jnp.asarray(p_nor)

    @jax.jit
    def atlas_grad(g):
        return jax.grad(lambda a: jnp.sum(sample(a, pj) * g))(sharded)

    @jax.jit
    def band_vjp(quad, g, d):
        return jax.vjp(lambda q, x: sample_local(q, x, d), quad, pj)[1](g)

    rows = js.local_rows
    # A band's own rows: all but its first row of each plane band, which
    # the band before reads as its halo.
    own = np.ones(rows, bool)
    for off, w in zip(js.local_off, js.W):
        own[off:off + w] = False
    quads = band_quads(layout, torch.as_tensor(atlas), n_bands,
                       torch.float32)[1]
    for d, (band, quad) in enumerate(quads):
        q = jnp.asarray(quad.numpy(), jdt)
        grads = [(*band_vjp(q, jnp.asarray(g), d), np.asarray(
            atlas_grad(jnp.asarray(g)))[d * rows:(d + 1) * rows][own])
            for g in variants(band)]
        for got in grads[1:]:
            for a, b in zip(got, grads[0]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert all(np.abs(np.asarray(g, np.float32)).max() > 0
                   for g in grads[0])
