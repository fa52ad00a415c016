"""``parallel.dp_impl: spmd`` (ROADMAP A1): the ray-DP mapper that draws
what one device draws, and the row-sharded Adam of ``zero_opt``
(``engine/mapper.py``, ``distributed.reduce_grads_rows`` /
``all_gather_rows``), on 2 gloo ranks.

One gang runs ``make_mapper(sharded=True, spmd=True)`` twice on the same
replayed draws: with the row-sharded Adam (``min_rows`` lowered to
``MIN_ROWS`` so that both atlases of the small scene, 858 and 3,011
rows, are sharded and the decoders are not) and with the replicated
Adam.  The draws are JAX's single-device ``make_mapper``'s
(``mapper.py:176-199``): the whole batch of 125 rays (one padded tail
row on 2 ranks), then the renderer's jitter and importance draws of the
whole batch, of which each rank takes its rows (``RowShardDraws``).

  * (a) The row-sharded Adam equals the replicated one bit for bit: the
    update is elementwise, and on 2 ranks each summed element is a + b
    in either order, whether the reduce-scatter or the all-reduce adds
    them.  Per iteration one ``grad_rs`` (the reduce-scatter of both
    atlases' padded row blocks), one ``grad`` (the all-reduce of the
    decoders and poses), one ``zero_gather`` of the padded row blocks;
    each rank's moments are its own rows'.  The reduction alone, on
    parameters of odd row counts and 1-D ones: each rank's rows of the
    summed gradients, bit for bit the numpy sum's; with no parameter of
    ``min_rows`` rows, one all-reduce of them all.
  * (b) Against JAX's ``make_mapper(ray_sharding=..., opt_sharding=...)``
    on 2 virtual devices (its row sharder leaves these small atlases
    whole; the math is the same), whose draws are its single device's:
    under the constraint-based sharding JAX's gradient is the exact
    global one, so the loss weights are not doubled (R5 is shard_map's).
    And against the port's single rank on the same draws.

Tolerances are test_torch_parallel.py's: against JAX losses rtol 1e-5,
poses atol 1e-5, the map as ``assert_map``; the port's 2 ranks against
its own single rank losses rtol 1e-6, map and poses atol 1e-6 (the two
partial sums reassociate once).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.engine import mapper as jmapper
from test_torch_parallel import ITERS, assert_map, dp_draws, fresh, \
    grad_bytes, map_np, mesh, spec_of, window
from test_torch_slice import Pair, small_cfg
from torch_gang import each, mapper_case, reduce_rows_case, run_ranks

torch.set_num_threads(2)  # several test workers share the CPU

N_RAYS = 125
MIN_ROWS = 256
# Parameters of the reduction's own case: odd row counts on both sides of
# MIN_ROWS, 1-D ones.
SHAPES = ((7, 3), (859, 8), (16,), (3011, 8))


@pytest.fixture(autouse=True)
def _scatter_route(monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)


@pytest.fixture(scope="module")
def gang():
    """The two spmd runs and the reduction's two cases (both large
    parameters sharded, none) on one gang of 2 ranks: [zero, replicated,
    reduction, reduction of nothing sharded] per rank."""
    cfg = small_cfg(perturb=True)
    cfg["mapping"]["pixels"] = N_RAYS
    pair = Pair(cfg)
    win = window(pair)
    key = jax.random.PRNGKey(4)
    draws = dp_draws(key, N_RAYS, 1, pair, True)
    spec = spec_of(pair, importance=True)
    args = (cfg, spec, map_np(pair), win, draws, ITERS, True, True)
    outs = run_ranks(each, 2, [(mapper_case, args + (MIN_ROWS,)),
                               (mapper_case, args),
                               (reduce_rows_case, (SHAPES, MIN_ROWS, 0)),
                               (reduce_rows_case, (SHAPES, 10 ** 6, 1))])
    return types.SimpleNamespace(cfg=cfg, pair=pair, win=win, key=key,
                                 draws=draws, spec=spec, outs=outs)


def test_row_sharded_adam_is_the_replicated_adam(gang):
    """(a) Both ranks, the row-sharded Adam against the replicated one:
    losses, poses and the whole map bit for bit, the collectives counted
    exactly, each rank's moments those of its own rows."""
    pair = gang.pair
    sdf, color = pair.ms.sdf_atlas, pair.ms.color_atlas
    for rank, (zero, repl, _, _) in enumerate(gang.outs):
        for name in ("losses", "poses"):
            np.testing.assert_array_equal(zero[name], repl[name])
            np.testing.assert_array_equal(zero[name],
                                          gang.outs[0][0][name])
        for name in ("sdf_atlas", "color_atlas"):
            np.testing.assert_array_equal(zero["map"][name],
                                          repl["map"][name])
        for a, b in zip(jax.tree_util.tree_leaves(zero["map"]["decoder"]),
                        jax.tree_util.tree_leaves(repl["map"]["decoder"])):
            np.testing.assert_array_equal(a, b)
        assert zero["left"] == repl["left"] == 0
        # Padded blocks: ceil(rows / 2) rows of each atlas per rank.
        gathered = 2 * 4 * sum(-(-a.shape[0] // 2) * a.shape[1]
                               for a in (sdf, color))
        atlases = 4 * (sdf.numel() + color.numel())
        counts = zero["counts"]
        assert {k: counts[k]["calls"] for k in counts} == {
            "grad_rs": ITERS, "grad": ITERS, "zero_gather": ITERS,
            "loss": ITERS}
        assert counts["grad_rs"]["bytes"] == ITERS * gathered
        assert counts["grad"]["bytes"] == ITERS * (grad_bytes(pair)
                                                   - atlases)
        assert counts["zero_gather"]["bytes"] == ITERS * gathered
        assert repl["counts"]["grad"]["calls"] == ITERS
        assert "grad_rs" not in repl["counts"]
        # Adam's two moments of this rank's rows alone.
        own = 2 * 4 * sum(
            (min((rank + 1) * -(-a.shape[0] // 2), a.shape[0])
             - rank * -(-a.shape[0] // 2)) * a.shape[1]
            for a in (sdf, color))
        full = 2 * atlases
        assert zero["adam_bytes"] == {"atlas_moments": own,
                                      "atlas_moments_replicated": full}
        assert repl["adam_bytes"]["atlas_moments"] == 0
    parts = [rank[2] for rank in gang.outs]
    for rank, out in enumerate(parts):
        assert out["sharded"] == [False, True, False, True]
        for k, shape in enumerate(SHAPES):
            total = parts[0]["grads"][k] + parts[1]["grads"][k]
            if out["sharded"][k]:
                rows = -(-shape[0] // 2)
                total = total[rank * rows:(rank + 1) * rows]
            np.testing.assert_array_equal(out["rs"][k], total)
        c = out["counts"]
        assert {k: v["calls"] for k, v in c.items()} == {"grad_rs": 1,
                                                        "grad": 1}
        assert c["grad_rs"]["bytes"] == 2 * 4 * (430 * 8 + 1506 * 8)
        assert c["grad"]["bytes"] == 4 * (7 * 3 + 16)
    # No parameter reaches min_rows: the replicated all-reduce alone.
    parts = [rank[3] for rank in gang.outs]
    for out in parts:
        assert out["sharded"] == [False] * len(SHAPES)
        for k in range(len(SHAPES)):
            np.testing.assert_array_equal(
                out["rs"][k], parts[0]["grads"][k] + parts[1]["grads"][k])
        assert {k: v["calls"] for k, v in out["counts"].items()} == {
            "grad": 1}


def test_spmd_mapper_matches_jax(gang):
    """(b) The row-sharded spmd step against JAX's constraint-sharded
    step on 2 devices, and against the port's single rank on the same
    draws: ray data parallelism that equals one device."""
    cfg, pair, win = gang.cfg, gang.pair, gang.win
    got = gang.outs[0][0]

    dp = mesh("dp")
    step = jmapper.make_mapper(
        cfg, pair.jscene, pair.jcam, importance=True,
        ray_sharding=NamedSharding(dp, P("dp")),
        opt_sharding=NamedSharding(dp, P("dp", None)))
    jms, jposes, jlosses = step(
        fresh(pair), jnp.asarray(win["poses"]),
        jnp.asarray(win["pose_mask"]),
        jnp.asarray(win["slot_kf"], jnp.int32), jnp.int32(3),
        jnp.asarray(win["kf_colors"]), jnp.asarray(win["kf_depths"]),
        gang.key, iters=ITERS, lr_factor=1.0)
    np.testing.assert_allclose(got["losses"], np.asarray(jlosses),
                               rtol=1e-5)
    np.testing.assert_allclose(got["poses"], np.asarray(jposes),
                               atol=1e-5)
    assert_map(got["map"], jms)
    assert np.abs(got["poses"] - win["poses"]).max() > 1e-5
    one = mapper_case(cfg, gang.spec, map_np(pair), win, gang.draws, ITERS,
                      False)
    assert one["left"] == 0 and one["counts"] == {}
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-6)
    np.testing.assert_allclose(got["poses"], one["poses"], atol=1e-6)
    for k in ("sdf_atlas", "color_atlas"):
        np.testing.assert_allclose(got["map"][k], one["map"][k], atol=1e-6)
