"""The port's frame mapper against JAX's on a populated keyframe store.

Frame 24 of the synthetic room is mapped against six stored keyframes
with joint pose optimization on and no admission: the overlap selector
picks a window of several slots, the ray budget is split round-robin
over them, the poses of all but the oldest slot get gradients (through
the tri-plane sample's coordinate gradient), and the optimized poses are
written back under the pose mask.  Same map, imagery and replayed draws
on both sides (see tests/test_torch_slice.py for the helpers).

Tolerances, ten times the gaps measured on this case after three Adam
steps (lr 0.005 on the atlases, 0.001 on the poses): losses rtol 1e-5
(measured 4e-7), map and decoder atol 1e-5 (measured 1.0e-6), the
written-back poses atol 3e-6 (measured 2.7e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.engine import keyframes as jkf
from myslam_tpu.engine import mapper as jmapper
from myslam_torch.core.sampling import ReplayDraws
from myslam_torch.engine import keyframes as tkf
from myslam_torch.engine import mapper as tmapper
from test_torch_slice import N, Pair, assert_map_close, \
    map_iteration_draws, selector_draws, small_cfg

torch.set_num_threads(2)  # several test workers share the CPU

CAPACITY = 8
KEYFRAMES = (0, 4, 8, 12, 16, 20)
IDX = 24


def test_window_mapping_with_joint_poses_matches_jax(monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)
    cfg = small_cfg(perturb=False)
    cfg["data"]["n_frames"] = IDX + 1
    # The overlap scorer ignores a 20-pixel border: a wide enough camera.
    cfg["cam"].update(H=120, W=160, fx=100.0, fy=100.0, cx=79.5, cy=59.5)
    cfg["mapping"].update(iters=3, mapping_window_size=3)
    pair = Pair(cfg)
    m = cfg["mapping"]
    w_max = int(m["mapping_window_size"]) + 2
    scratch = CAPACITY - 1
    iters = int(m["iters"])

    rng = np.random.default_rng(0)
    colors = np.zeros((CAPACITY, 120, 160, 3), np.float16)
    depths = np.zeros((CAPACITY, 120, 160), np.float32)
    kf_est = np.tile(np.eye(4, dtype=np.float32), (CAPACITY, 1, 1))
    kf_gt = kf_est.copy()
    for slot, f in enumerate(KEYFRAMES):
        c, d, gt = pair.dataset.get_frame(f)
        colors[slot], depths[slot], kf_gt[slot] = c, d, gt
        kf_est[slot] = gt
        kf_est[slot, :3, 3] += rng.normal(scale=0.005, size=3)
    est = np.stack([pair.dataset.poses[f] for f in range(IDX + 1)])
    est[IDX, :3, 3] += 0.01
    pkt = pair.packet(IDX, need_full=True)
    key = jax.random.PRNGKey(9)

    jsel = jkf.make_window_selector(pair.jcam, CAPACITY,
                                    int(m["mapping_window_size"]), w_max,
                                    scratch)
    jmap = jmapper.make_frame_mapper(cfg, pair.jscene, pair.jcam, jsel,
                                     w_max, scratch, importance=False)
    opt_buf = jmap.jit_init({"map": pair.jms,
                             "poses": jnp.zeros((w_max, 7), jnp.float32)})
    (jms, _, jest, jkf_est, _, _, _, jlosses) = jmap(
        pair.jms, opt_buf, jnp.asarray(est), jnp.asarray(kf_est),
        jnp.asarray(kf_gt), jnp.asarray(colors), jnp.asarray(depths),
        jnp.asarray(pkt.color_u8), jnp.asarray(pkt.depth_u16),
        pkt.depth_inv_q, jnp.asarray(pkt.gt_c2w), IDX, len(KEYFRAMES), key,
        iters=iters, lr_factor=1.0, joint_opt=True, admit=False)
    jslot_kf, jn_slots, _ = jsel(
        jnp.asarray(kf_est), len(KEYFRAMES), jnp.asarray(est[IDX]),
        jnp.asarray(pkt.depth_u16.astype(np.float32) * pkt.depth_inv_q),
        jax.random.fold_in(key, 0x7FFFFFFF), 1.0)
    assert int(jn_slots) >= 4  # a real window: picks, last two, current

    store = tkf.KeyframeStore(CAPACITY, pair.cam, "cpu")
    store.colors[:] = torch.tensor(colors)
    store.depths[:] = torch.tensor(depths)
    store.est_c2w[:] = torch.tensor(kf_est)
    store.gt_c2w[:] = torch.tensor(kf_gt)
    store.count = len(KEYFRAMES)
    sel = tkf.make_window_selector(pair.cam, CAPACITY,
                                   int(m["mapping_window_size"]), w_max,
                                   scratch)
    map_frame = tmapper.make_frame_mapper(cfg, pair.scene, pair.cam, sel,
                                          w_max, scratch, importance=False)
    draws = selector_draws(jax.random.fold_in(key, 0x7FFFFFFF), pair.jcam,
                           CAPACITY)
    for it in range(iters):
        draws += map_iteration_draws(key, it, int(m["pixels"]), pair.jcam,
                                     pair.jscene, False)
    replay = ReplayDraws(draws)
    test = torch.tensor(est)
    losses = map_frame(
        pair.ms, store, test, torch.tensor(pkt.color_u8),
        torch.tensor(pkt.depth_u16.astype(np.float32)), pkt.depth_inv_q,
        torch.tensor(pkt.gt_c2w), IDX, replay, iters=iters, lr_factor=1.0,
        joint_opt=True, admit=False)
    assert len(replay) == 0

    np.testing.assert_allclose(N(losses), np.asarray(jlosses), rtol=1e-5)
    assert_map_close(pair.ms, jms, atol=1e-5, sdf_atol=1e-5)
    np.testing.assert_allclose(N(store.est_c2w), np.asarray(jkf_est),
                               atol=3e-6)
    np.testing.assert_allclose(N(test), np.asarray(jest), atol=3e-6)
    # The window's poses moved, the oldest slot's did not.
    moved = np.abs(np.asarray(jkf_est) - kf_est).max(axis=(1, 2))
    slots = np.asarray(jslot_kf)[:int(jn_slots) - 1]
    assert moved[slots[0]] == 0.0 and (moved[slots[1:]] > 0).all()
    assert np.abs(N(test)[IDX] - est[IDX]).max() > 0
