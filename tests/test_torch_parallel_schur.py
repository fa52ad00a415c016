"""The reduced (Schur) pose solve of keyframe-sharded BA engaged over
several frames and iterations: ``make_kf_frame_mapper`` on 2 gloo ranks
against the JAX package's on a 2-device kf mesh, with the rules and
helpers of test_torch_parallel_ba.py (JAX's draws replayed, the port's
loss weights doubled).

At 24x32 with 128 rays a solve moves the poses ~20 cm and the problem
amplifies a 1e-6 difference ~30x per solve, so test_torch_parallel_ba.py
holds one solve there.  At 48x64 with 512 rays, on a map trained for 200
iterations at poses 4 mm from the ground truth, a solve moves the poses
by millimetres and a 1e-6 difference stays under 1e-5 over four solves
(measured on JAX's step), so the port can be held against JAX through
three mapped frames of three solves each.

Tolerances: poses atol 1e-5 as for one solve (measured 8e-7 after nine
chained solves), losses rtol 1e-4 (measured 4e-5), the decoders 1e-4,
and both atlases 5e-4: after nine Adam steps the color atlas's few
near-cancelling gradient entries differ as the SDF atlas's do after
three (measured 3.2e-4 and 3.6e-4; see test_torch_parallel.py).

The run also shows what the reference's solve does to a trajectory:
each frame's pose moves 0.8-1.6 cm, and after the third frame the first
two of these keyframes sit 2.2 and 2.0 cm from the ground truth,
starting from 0.7 cm (JAX's step; the port's within 1e-6 of it).

A second case takes the parameter that ``tools/bench_pose_solver.py``
sets on the bare BA step (``make_distributed_ba``'s ``schur_interval``,
``distributed_ba.py:138``): ``schur_interval: 2`` over three iterations
(the solve on iterations 0 and 2, the map step alone on iteration 1) on
the window of keyframes 0-3, keyframe 0 frozen and the others 4 mm
further off, against JAX's ``make_distributed_ba`` with the same
interval, at the tolerances above but the color atlas's: 2e-3, where two
of its 24,088 entries, near-cancelling, differ by up to 9.2e-4 after the
three Adam steps (measured; Adam scales each entry's step by its own
gradient's running size, so an entry whose gradient nearly cancels moves
by a fair part of the 5e-3 learning rate on a gradient difference of
float32 rounding).  Both cases start from one map
trained by JAX (``scene``) and run on one gang of 2 ranks (``runs``),
shared by the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.core.quaternion import matrix_to_cam_pose
from myslam_tpu.engine import keyframes as jkf
from myslam_tpu.engine import mapper as jmapper
from myslam_tpu.parallel import distributed_ba as jdba
from test_torch_parallel import assert_map, doubled, fresh, map_np, mesh, \
    spec_of
from test_torch_parallel_ba import kf_draws
from test_torch_slice import Pair, render_draws, selector_draws, small_cfg
from torch_gang import each, kf_ba_case, kf_frame_case, run_ranks

torch.set_num_threads(2)  # several test workers share the CPU

FRAMES = (4, 5, 6)  # mapped and admitted in turn, after keyframes 0-3
ITERS = 3  # solves per frame
CAP, WINDOW = 8, 3


@pytest.fixture(autouse=True)
def _scatter_route(monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)


def frame_draws(key, pair, cap, n_local):
    """One kf frame's draws in the port's order: the selector's, then per
    iteration both shards' folded pixel draws and the renderer's."""
    draws = [np.asarray(d) for d in selector_draws(
        jax.random.fold_in(key, 0x7FFFFFFF), pair.jcam, cap)]
    for it in range(ITERS):
        k_ray, k_z = jax.random.split(jax.random.fold_in(key, it))
        keys = [jax.random.split(jax.random.fold_in(k_ray, me))
                for me in range(2)]
        draws += [np.stack([np.asarray(jax.random.randint(
            ki, (n_local,), 0, pair.jcam.W)) for ki, _ in keys]),
                  np.stack([np.asarray(jax.random.randint(
                      kj, (n_local,), 0, pair.jcam.H)) for _, kj in keys])]
        draws += [np.asarray(d) for d in render_draws(
            k_z, n_local, pair.jscene, False)]
    return draws


@pytest.fixture(scope="module")
def scene():
    """The 48x64 room: keyframes 0-3 in an 8-slot store, their poses
    jittered by 4 mm, frames 4-6 starting 4 mm off, and JAX's map
    trained for 200 iterations at the keyframes' poses."""
    monkey = pytest.MonkeyPatch()
    monkey.setattr(jps, "ONEHOT_MAX_ROWS", 0)
    cfg = small_cfg(perturb=True)
    cfg["cam"].update(H=48, W=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5)
    cfg["mapping"]["pixels"] = 512
    cfg["data"]["n_frames"] = FRAMES[-1] + 1
    pair = Pair(cfg)
    rng = np.random.default_rng(2)
    cam = pair.cam
    colors = np.zeros((CAP, cam.H, cam.W, 3), np.float16)
    depths = np.zeros((CAP, cam.H, cam.W), np.float32)
    kf_est = np.tile(np.eye(4, dtype=np.float32), (CAP, 1, 1))
    for s in range(4):
        c, d, gt = pair.dataset.get_frame(s)
        colors[s], depths[s], kf_est[s] = c, d, gt
        kf_est[s, :3, 3] += rng.normal(scale=0.004, size=3)
    est = np.tile(np.eye(4, dtype=np.float32), (FRAMES[-1] + 1, 1, 1))
    est[:4] = kf_est[:4]
    pkts = [pair.packet(f, need_full=True) for f in FRAMES]
    for f, pkt in zip(FRAMES, pkts):
        est[f] = pkt.gt_c2w
        est[f, :3, 3] += 0.004
    step = jmapper.make_mapper(cfg, pair.jscene, pair.jcam, importance=False)
    pair.jms, _, _ = step(
        fresh(pair), matrix_to_cam_pose(jnp.asarray(kf_est[:4])),
        jnp.zeros((4,)), jnp.arange(4, dtype=jnp.int32), jnp.int32(4),
        jnp.asarray(colors), jnp.asarray(depths), jax.random.PRNGKey(99),
        iters=200, lr_factor=1.0)
    monkey.undo()
    return {"cfg": cfg, "pair": pair, "colors": colors, "depths": depths,
            "kf_est": kf_est, "est": est, "pkts": pkts}


def jax_frames(sc):
    """FRAMES mapped in turn by JAX's kf frame mapper on 2 devices from
    the scene's map: its per-frame records and map, and the port's
    arguments of ``kf_frame_case``."""
    cfg, pair, est = sc["cfg"], sc["pair"], sc["est"]
    w_max = WINDOW + 2
    jsel = jkf.make_window_selector(pair.jcam, CAP, WINDOW, w_max, CAP - 1)
    jmap = jdba.make_kf_frame_mapper(cfg, pair.jscene, pair.jcam, jsel,
                                     w_max, CAP - 1, mesh("kf"),
                                     importance=False, pose_solver="schur")
    sh = NamedSharding(mesh("kf"), P("kf"))
    jms, jest, jkf_est = fresh(pair), jnp.asarray(est), jnp.asarray(
        sc["kf_est"])
    jkf_gt = jnp.asarray(sc["kf_est"])
    jcolors = jax.device_put(jnp.asarray(sc["colors"]), sh)
    jdepths = jax.device_put(jnp.asarray(sc["depths"]), sh)
    n_local = int(cfg["mapping"]["pixels"]) // 2
    ref, draws, packets = [], [], []
    for n, (f, pkt) in enumerate(zip(FRAMES, sc["pkts"])):
        key = jax.random.PRNGKey(20 + f)
        opt_buf = jmap.jit_init({"map": jms, "poses": jnp.zeros(
            (w_max, 7), jnp.float32)})
        (jms, _, jest, jkf_est, jkf_gt, jcolors, jdepths, jlosses) = jmap(
            jms, opt_buf, jest, jkf_est, jkf_gt, jcolors, jdepths,
            jnp.asarray(pkt.color_u8), jnp.asarray(pkt.depth_u16),
            pkt.depth_inv_q, jnp.asarray(pkt.gt_c2w), f, 4 + n, key,
            iters=ITERS, lr_factor=1.0, joint_opt=True, admit=True)
        ref.append({"est": np.asarray(jest), "kf_est": np.asarray(jkf_est),
                    "losses": np.asarray(jlosses)})
        draws += frame_draws(key, pair, CAP, n_local)
        packets.append({"color_u8": pkt.color_u8,
                        "depth_u16": pkt.depth_u16.astype(np.int64),
                        "inv_q": pkt.depth_inv_q, "gt_c2w": pkt.gt_c2w,
                        "idx": f})
    spec = {**spec_of(pair), "w_max": w_max, "window_size": WINDOW}
    store_np = {"colors": sc["colors"], "depths": sc["depths"],
                "est_c2w": sc["kf_est"], "gt_c2w": sc["kf_est"],
                "count": 4, "est": est}
    args = (doubled(cfg), spec, map_np(pair), store_np, packets, draws,
            ITERS, "schur")
    return ref, jms, args


def jax_interval(sc):
    """JAX's bare BA step with ``schur_interval: 2`` over ITERS
    iterations on 2 devices from the scene's map, on the window of
    keyframes 0-3 (slots 0-1 on rank 0, 2-3 on rank 1), keyframe 0
    frozen and the others 4 mm further off: its poses, losses and map,
    the window, and the port's arguments of ``kf_ba_case``."""
    cfg, pair = sc["cfg"], sc["pair"]
    c2ws = sc["kf_est"][:4].copy()
    c2ws[1:, :3, 3] += 0.004
    win = {"poses": np.asarray(matrix_to_cam_pose(jnp.asarray(c2ws))),
           "pose_mask": np.array([0, 1, 1, 1], np.float32),
           "slot_kf": np.arange(4), "n_slots": 4,
           "kf_colors": sc["colors"][:4], "kf_depths": sc["depths"][:4]}
    key = jax.random.PRNGKey(30)
    jstep = jdba.make_distributed_ba(cfg, pair.jscene, pair.jcam,
                                     mesh("kf"), iters=ITERS,
                                     pose_solver="schur", schur_interval=2)
    jms, jposes, jlosses = jstep(
        fresh(pair), jnp.asarray(win["poses"]),
        jnp.asarray(win["pose_mask"]), jnp.asarray(win["slot_kf"],
                                                   jnp.int32),
        jnp.int32(4), jnp.asarray(win["kf_colors"]),
        jnp.asarray(win["kf_depths"]), key)
    local = {r: (win["kf_colors"][2 * r:2 * r + 2],
                 win["kf_depths"][2 * r:2 * r + 2]) for r in range(2)}
    n_rays = int(cfg["mapping"]["pixels"]) // 2
    args = (doubled(cfg), spec_of(pair), map_np(pair), win, local,
            kf_draws(key, n_rays, pair, ITERS), ITERS, "schur", 2)
    return ({"poses": np.asarray(jposes), "losses": np.asarray(jlosses),
             "win": win}, jms, args)


@pytest.fixture(scope="module")
def runs(scene):
    """Each case of CASES: JAX's records and map, and the ranks' outputs,
    the port's cases on one gang."""
    monkey = pytest.MonkeyPatch()
    monkey.setattr(jps, "ONEHOT_MAX_ROWS", 0)
    try:
        jax_side = {"every": jax_frames(scene),
                    "interval": jax_interval(scene)}
    finally:
        monkey.undo()
    fns = {"every": kf_frame_case, "interval": kf_ba_case}
    outs = run_ranks(each, 2, [(fns[name], jax_side[name][2])
                               for name in fns], timeout=240)
    return {name: (jax_side[name][0], jax_side[name][1],
                   [rank[k] for rank in outs])
            for k, name in enumerate(fns)}


def test_kf_schur_frames_match_jax(scene, runs):
    """Three frames mapped with joint poses by the damped reduced solve,
    three solves each, every frame admitted (a 8-slot store, 4 slots per
    rank, the admitted frames in rank 1's): the trajectory and the
    store's poses after each frame, the losses and the final map against
    JAX's; the solve moves every frame's pose, and the ranks agree bit
    for bit."""
    ref, jms, outs = runs["every"]
    est = scene["est"]
    for out in outs:
        assert out["left"] == 0
        assert out["counts"]["schur"]["calls"] == ITERS * len(FRAMES)
        np.testing.assert_array_equal(np.stack(out["est"]),
                                      np.stack(outs[0]["est"]))
        np.testing.assert_array_equal(np.stack(out["kf_est"]),
                                      np.stack(outs[0]["kf_est"]))
    got = outs[0]
    for n, f in enumerate(FRAMES):
        np.testing.assert_allclose(got["losses"][n] / 2, ref[n]["losses"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["est"][n], ref[n]["est"], atol=1e-5)
        np.testing.assert_allclose(got["kf_est"][n], ref[n]["kf_est"],
                                   atol=1e-5)
        assert np.abs(got["est"][n][f] - est[f]).max() > 1e-3
    # Nine Adam steps: the color atlas's near-cancelling entries as the
    # SDF atlas's after three.
    assert_map(got["map"], jms, atol=1e-4, sdf_atol=5e-4, color_atol=5e-4)


def test_distributed_ba_schur_interval_matches_jax(scene, runs):
    """make_distributed_ba with ``schur_interval: 2`` over three
    iterations: two reduced systems (iterations 0 and 2) and three
    gradient all-reduces per rank, the ranks bit for bit, and the poses,
    losses and map against JAX's bare step with the same interval; the
    solves move the poses."""
    ref, jms, outs = runs["interval"]
    for out in outs:
        assert out["left"] == 0
        assert out["counts"]["schur"]["calls"] == 2
        assert out["counts"]["grad"]["calls"] == ITERS
        np.testing.assert_array_equal(out["poses"], outs[0]["poses"])
    got = outs[0]
    np.testing.assert_allclose(got["losses"] / 2, ref["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["poses"], ref["poses"], atol=1e-5)
    assert np.abs(got["poses"] - ref["win"]["poses"]).max() > 1e-3
    assert_map(got["map"], jms, atol=1e-4, sdf_atol=5e-4, color_atol=2e-3)
