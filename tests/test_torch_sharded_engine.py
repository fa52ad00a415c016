"""The frame mapper over banded map shards (``make_frame_mapper`` with
``myslam_torch/parallel/sharded_engine.py``'s ``queries_factory``) on 2
gloo ranks against the JAX package's ``make_sharded_frame_mapper`` on 2
of the virtual CPU devices (conftest).

One mapped frame (selection, three iterations with joint poses, the
importance branch on depth holes, the pose write-back, admission) from
the same map, keyframes and packet in both, JAX's draws replayed on both
ranks (the selector's, then per iteration the pixel draws and the
renderer's: every rank draws the same rays, ``tests/torch_gang.py``).
The map after ``unshard``, the poses and the losses are held at the
gang tests' float32 tolerances (test_torch_parallel.py): losses rtol
1e-5, poses atol 1e-5, the decoders and the color atlas atol 1e-4, the
SDF atlas 5e-4.  JAX's sharded mapper differentiates a sample whose psum
runs under shard_map outside the loss, and takes the global gradient:
no factor between the two.  The two ranks end with the same replicated
map and trajectory, bit for bit, and the run makes the halo, feature and
coordinate-gradient transfers it should.

The pack, sample and their gradients alone are held against JAX's in
test_torch_plane_shard.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.engine import keyframes as jkf
from myslam_tpu.parallel import sharded_engine as jse
from test_torch_parallel import map_np, spec_of
from test_torch_slice import Pair, map_iteration_draws, selector_draws, \
    small_cfg
from torch_gang import run_ranks, sharded_frame_case

torch.set_num_threads(2)  # several test workers share the CPU

ITERS = 3
CAP = 5  # three keyframes, a spare and the scratch slot
WINDOW = 3


@pytest.fixture(autouse=True)
def _scatter_route(monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)


def test_sharded_frame_mapper_matches_jax():
    cfg = small_cfg(perturb=True)
    cfg["mapping"]["mapping_window_size"] = WINDOW
    pair = Pair(cfg)
    cam = pair.cam
    rng = np.random.default_rng(4)
    colors = np.zeros((CAP, cam.H, cam.W, 3), np.float16)
    depths = np.zeros((CAP, cam.H, cam.W), np.float32)
    kf_est = np.tile(np.eye(4, dtype=np.float32), (CAP, 1, 1))
    for s in range(3):
        c, d, gt = pair.dataset.get_frame(s)
        colors[s], depths[s], kf_est[s] = c, d, gt
        kf_est[s, :3, 3] += rng.normal(scale=0.004, size=3)
    depths[1, 3:9, 5:14] = 0.0  # depth holes: the importance branch
    kf_gt = kf_est.copy()
    pkt = pair.packet(3, need_full=True)
    est = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    est[:3] = kf_est[:3]
    est[3] = pkt.gt_c2w
    est[3, :3, 3] += 0.004
    w_max = WINDOW + 2
    key = jax.random.PRNGKey(7)

    mesh = Mesh(np.array(jax.devices()[:2]), ("map",))
    smg = jse.ShardedMapGeometry(mesh, pair.jscene)
    jsel = jkf.make_window_selector(pair.jcam, CAP, WINDOW, w_max, CAP - 1)
    jmap = jse.make_sharded_frame_mapper(cfg, pair.jscene, pair.jcam, jsel,
                                         w_max, CAP - 1, smg,
                                         importance=True)
    banded = smg.shard(pair.jms)
    opt_buf = jmap.jit_init({"map": banded,
                             "poses": jnp.zeros((w_max, 7), jnp.float32)})
    (jbanded, _, jest, jkf_est, _, _, _, jlosses) = jmap(
        banded, opt_buf, jnp.asarray(est), jnp.asarray(kf_est),
        jnp.asarray(kf_gt), jnp.asarray(colors), jnp.asarray(depths),
        jnp.asarray(pkt.color_u8), jnp.asarray(pkt.depth_u16),
        pkt.depth_inv_q, jnp.asarray(pkt.gt_c2w), 3, 3, key, iters=ITERS,
        lr_factor=1.0, joint_opt=True, admit=True)
    jms = smg.unshard(jbanded)

    draws = [np.asarray(d) for d in selector_draws(
        jax.random.fold_in(key, 0x7FFFFFFF), pair.jcam, CAP)]
    for it in range(ITERS):
        draws += [np.asarray(d) for d in map_iteration_draws(
            key, it, int(cfg["mapping"]["pixels"]), pair.jcam, pair.jscene,
            True)]
    store_np = {"colors": colors, "depths": depths, "est_c2w": kf_est,
                "gt_c2w": kf_gt, "count": 3, "est": est}
    packet = {"color_u8": pkt.color_u8,
              "depth_u16": pkt.depth_u16.astype(np.int64),
              "inv_q": pkt.depth_inv_q, "gt_c2w": pkt.gt_c2w, "idx": 3}
    outs = run_ranks(sharded_frame_case, 2, cfg,
                     spec_of(pair, importance=True), map_np(pair),
                     store_np, packet, draws, ITERS, CAP, WINDOW,
                     timeout=240)
    for out in outs:
        assert out["left"] == 0
        c = out["counts"]
        assert c["features"]["calls"] > 0 and c["coord_grad"]["calls"] > 0
        assert c["halo"]["calls"] > 0 and c["bands"]["calls"] == 2
        assert "grad" not in c  # the atlas gradients stay on their rank
        for k in ("est", "kf_est", "losses"):
            np.testing.assert_array_equal(out[k], outs[0][k])
        for k in ("sdf_atlas", "color_atlas"):
            np.testing.assert_array_equal(out["map"][k], outs[0]["map"][k])
    got = outs[0]
    assert got["band_rows"] * 2 >= pair.scene.sdf_layout.total_rows
    np.testing.assert_allclose(got["losses"], np.asarray(jlosses),
                               rtol=1e-5)
    np.testing.assert_allclose(got["est"], np.asarray(jest), atol=1e-5)
    np.testing.assert_allclose(got["kf_est"], np.asarray(jkf_est),
                               atol=1e-5)
    np.testing.assert_allclose(got["map"]["sdf_atlas"],
                               np.asarray(jms.sdf_atlas), atol=5e-4, rtol=0)
    np.testing.assert_allclose(got["map"]["color_atlas"],
                               np.asarray(jms.color_atlas), atol=1e-4,
                               rtol=0)
    for g, r in zip(jax.tree_util.tree_leaves(got["map"]["decoder"]),
                    jax.tree_util.tree_leaves(jms.decoder)):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-4, rtol=0)
    # Joint BA moved the current frame's pose: the comparison is not
    # vacuous.
    assert np.abs(got["est"][3] - est[3]).max() > 1e-5
