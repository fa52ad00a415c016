"""Keyframe-sharded bundle adjustment (``parallel/distributed_ba.py``) on
2 gloo ranks against the JAX package's on a 2-device kf mesh: the bare
BA step with either pose solver, the reduced (Schur) pose system, and
the frame mapper of the loop's kf mode.

Each rank holds only its own keyframe slots.  The draws, the doubled
loss weights (JAX's shard_map steps take twice the global gradient on 2
devices, ROADMAP R5) and the tolerances are those of
test_torch_parallel.py; the cases start from a map trained at the
window's poses, since on a random map a Gauss-Newton pose step leaves
the room.  The Schur cases run one iteration: a solve moves the poses
~16 cm on this 24x32 map, and a second solve from poses 1e-6 apart
lands 2e-4 apart (measured), the problem's sensitivity and not the
port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.core.quaternion import matrix_to_cam_pose
from myslam_tpu.core.sampling import depth_guided_z_vals
from myslam_tpu.engine import keyframes as jkf
from myslam_tpu.engine import mapper as jmapper
from myslam_tpu.parallel import distributed_ba as jdba
from test_torch_parallel import ITERS, assert_map, doubled, fresh, map_np, \
    mesh, spec_of, window
from test_torch_slice import Pair, render_draws, selector_draws, small_cfg
from torch_gang import kf_ba_case, kf_frame_case, pose_system_case, \
    run_ranks

torch.set_num_threads(2)  # several test workers share the CPU


@pytest.fixture(autouse=True)
def _scatter_route(monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)


def kf_draws(key, n_rays, pair, iters, ranks=2):
    """JAX's kf BA draws: each shard's folded pixel draws, stacked over
    shards, then the depth-guided jitter (shared key)."""
    out = []
    for it in range(iters):
        k_ray, k_z = jax.random.split(jax.random.fold_in(key, it))
        cols, rows = [], []
        for me in range(ranks):
            ki, kj = jax.random.split(jax.random.fold_in(k_ray, me))
            cols.append(np.asarray(jax.random.randint(ki, (n_rays,), 0,
                                                      pair.jcam.W)))
            rows.append(np.asarray(jax.random.randint(kj, (n_rays,), 0,
                                                      pair.jcam.H)))
        out += [np.stack(cols), np.stack(rows)]
        if pair.jscene.perturb:
            out.append(np.asarray(jax.random.uniform(
                k_z, (n_rays, pair.jscene.n_samples))))
    return out


def train_map(pair, win, iters=60):
    """Replace the pair's random map by one JAX's single-device mapper
    trained for ``iters`` iterations at the window's poses (frozen): on a
    random map a Gauss-Newton pose step leaves the room."""
    step = jmapper.make_mapper(pair.cfg, pair.jscene, pair.jcam,
                               importance=False)
    pair.jms, _, _ = step(
        fresh(pair), jnp.asarray(win["poses"]), jnp.zeros((4,)),
        jnp.asarray(win["slot_kf"], jnp.int32), jnp.int32(3),
        jnp.asarray(win["kf_colors"]), jnp.asarray(win["kf_depths"]),
        jax.random.PRNGKey(99), iters=iters, lr_factor=1.0)


@pytest.mark.parametrize("solver", ["adam", "schur"])
def test_distributed_ba_matches_jax(solver):
    """make_distributed_ba on 2 ranks, each holding 2 of the 4 slots,
    with the weights doubled against JAX's on a 2-device kf mesh (the
    damped solve is invariant to the doubling), on a trained map; the
    poses by Adam or by the damped reduced (Schur) solve.  One gradient
    all-reduce per iteration, and under schur one of the pose system."""
    cfg = small_cfg(perturb=True)
    pair = Pair(cfg)
    win = window(pair)
    train_map(pair, win)
    key = jax.random.PRNGKey(8)
    iters = ITERS if solver == "adam" else 1
    jstep = jdba.make_distributed_ba(cfg, pair.jscene, pair.jcam,
                                     mesh("kf"), iters=iters,
                                     pose_solver=solver)
    jms, jposes, jlosses = jstep(
        fresh(pair), jnp.asarray(win["poses"]), jnp.asarray(win["pose_mask"]),
        jnp.asarray(win["slot_kf"], jnp.int32), jnp.int32(3),
        jnp.asarray(win["kf_colors"]), jnp.asarray(win["kf_depths"]), key)
    n_rays = int(cfg["mapping"]["pixels"]) // 2
    local = {r: (win["kf_colors"][2 * r:2 * r + 2],
                 win["kf_depths"][2 * r:2 * r + 2]) for r in range(2)}
    outs = run_ranks(kf_ba_case, 2, doubled(cfg), spec_of(pair),
                     map_np(pair), win, local,
                     kf_draws(key, n_rays, pair, iters), iters, solver)
    for out in outs:
        assert out["left"] == 0
        assert out["counts"]["grad"]["calls"] == iters
        assert out["counts"].get("schur", {}).get("calls", 0) == (
            iters if solver == "schur" else 0)
        np.testing.assert_array_equal(out["poses"], outs[0]["poses"])
    np.testing.assert_allclose(outs[0]["losses"] / 2, np.asarray(jlosses),
                               rtol=1e-5)
    np.testing.assert_allclose(outs[0]["poses"], np.asarray(jposes),
                               atol=1e-5)
    assert_map(outs[0]["map"], jms)
    assert np.abs(outs[0]["poses"] - win["poses"]).max() > 1e-5


def jax_pose_system(pair, cfg):
    """JAX's bare pose_system (a closure of make_distributed_ba's step)
    under shard_map over 2 kf devices: per-shard rays in, psum'd H, g."""
    step = jdba.make_distributed_ba(cfg, pair.jscene, pair.jcam, mesh("kf"),
                                    iters=1, pose_solver="schur")
    fn = step.__wrapped__
    while "pose_system" not in fn.__code__.co_freevars:
        fn = fn.__wrapped__
    system = fn.__closure__[fn.__code__.co_freevars.index(
        "pose_system")].cell_contents

    def body(ms, poses, p, i, j, d, c, z, v):
        return system(ms, poses, p, i, j, d, c, z, v[0])

    return jax.jit(jax.shard_map(
        body, mesh=mesh("kf"),
        in_specs=(P(),) * 2 + (P("kf"),) * 7, out_specs=(P(), P()),
        check_vma=False))


def test_pose_system_matches_jax():
    """The reduced pose system H (W, 7, 7), g (W, 7) summed over 2
    ranks' rays against JAX's pose_system on the same rays split over 2
    devices, within 1e-4 of the largest entry; the ranks agree bit for
    bit."""
    cfg = small_cfg(perturb=False)
    pair = Pair(cfg)
    win = window(pair)
    rng = np.random.default_rng(3)
    R, W = 40, 4
    per = []
    for r in range(2):
        p = rng.integers(0, 3, R)
        i = rng.integers(0, pair.cam.W, R).astype(np.float32)
        j = rng.integers(0, pair.cam.H, R).astype(np.float32)
        slot = win["slot_kf"][p]
        d = win["kf_depths"][slot, j.astype(int), i.astype(int)]
        c = win["kf_colors"][slot, j.astype(int), i.astype(int)].astype(
            np.float32)
        z = np.asarray(depth_guided_z_vals(
            jax.random.PRNGKey(0), jnp.asarray(d), pair.jscene.truncation,
            pair.jscene.n_stratified, pair.jscene.n_importance, False))
        per.append({"p": p, "i": i, "j": j, "px_depth": d, "px_color": c,
                    "z_vals": z, "valid": np.array(True)})
    cat = {k: np.concatenate([per[0][k], per[1][k]]) for k in per[0]
           if k != "valid"}
    jH, jg = jax_pose_system(pair, cfg)(
        pair.jms, jnp.asarray(win["poses"]), cat["p"], cat["i"], cat["j"],
        cat["px_depth"], cat["px_color"], cat["z_vals"],
        np.array([True, True]))
    outs = run_ranks(pose_system_case, 2, cfg, spec_of(pair), map_np(pair),
                     win["poses"], per)
    for out in outs:
        np.testing.assert_array_equal(out["H"], outs[0]["H"])
    for got, ref in ((outs[0]["H"], np.asarray(jH)),
                     (outs[0]["g"], np.asarray(jg))):
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("solver", ["adam", "schur"])
def test_kf_frame_mapper_matches_jax(solver):
    """make_kf_frame_mapper on 2 ranks (a 6-slot store, 3 slots each, 4
    keyframes) with the weights doubled against JAX's on a 2-device kf
    mesh: frame 4 mapped with joint poses on a trained map, selection,
    the iterations, the pose write-back and admission into slot 4, which
    rank 1 holds."""
    cfg = small_cfg(perturb=True)
    pair = Pair(cfg)
    cap, window_size = 6, 3
    w_max = window_size + 2
    rng = np.random.default_rng(2)
    cam = pair.cam
    colors = np.zeros((cap, cam.H, cam.W, 3), np.float16)
    depths = np.zeros((cap, cam.H, cam.W), np.float32)
    kf_est = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
    for s in range(4):
        c, d, gt = pair.dataset.get_frame(s)
        colors[s], depths[s], kf_est[s] = c, d, gt
        kf_est[s, :3, 3] += rng.normal(scale=0.004, size=3)
    kf_gt = kf_est.copy()
    pkt = pair.packet(4, need_full=True)
    est = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    est[:4] = kf_est[:4]
    est[4] = pkt.gt_c2w
    est[4, :3, 3] += 0.004
    step = jmapper.make_mapper(cfg, pair.jscene, pair.jcam, importance=False)
    pair.jms, _, _ = step(
        fresh(pair), matrix_to_cam_pose(jnp.asarray(kf_est[:4])),
        jnp.zeros((4,)), jnp.arange(4, dtype=jnp.int32), jnp.int32(4),
        jnp.asarray(colors), jnp.asarray(depths), jax.random.PRNGKey(99),
        iters=60, lr_factor=1.0)
    key = jax.random.PRNGKey(12)
    iters = 3 if solver == "adam" else 1
    jsel = jkf.make_window_selector(pair.jcam, cap, window_size, w_max,
                                    cap - 1)
    jmap = jdba.make_kf_frame_mapper(cfg, pair.jscene, pair.jcam, jsel,
                                     w_max, cap - 1, mesh("kf"),
                                     importance=False, pose_solver=solver)
    opt_buf = jmap.jit_init({"map": fresh(pair),
                             "poses": jnp.zeros((w_max, 7), jnp.float32)})
    sh = NamedSharding(mesh("kf"), P("kf"))
    (jms, _, jest, jkf_est, _, jcolors, jdepths, jlosses) = jmap(
        fresh(pair), opt_buf, jnp.asarray(est), jnp.asarray(kf_est),
        jnp.asarray(kf_gt), jax.device_put(jnp.asarray(colors), sh),
        jax.device_put(jnp.asarray(depths), sh),
        jnp.asarray(pkt.color_u8), jnp.asarray(pkt.depth_u16),
        pkt.depth_inv_q, jnp.asarray(pkt.gt_c2w), 4, 4, key, iters=iters,
        lr_factor=1.0, joint_opt=True, admit=True)
    n_local = int(cfg["mapping"]["pixels"]) // 2
    draws = [np.asarray(d) for d in selector_draws(
        jax.random.fold_in(key, 0x7FFFFFFF), pair.jcam, cap)]
    for it in range(iters):
        k_ray, k_z = jax.random.split(jax.random.fold_in(key, it))
        keys = [jax.random.split(jax.random.fold_in(k_ray, me))
                for me in range(2)]
        draws += [np.stack([np.asarray(jax.random.randint(
            ki, (n_local,), 0, pair.jcam.W)) for ki, _ in keys]),
                  np.stack([np.asarray(jax.random.randint(
                      kj, (n_local,), 0, pair.jcam.H)) for _, kj in keys])]
        draws += [np.asarray(d) for d in render_draws(
            k_z, n_local, pair.jscene, False)]
    spec = {**spec_of(pair), "w_max": w_max, "window_size": window_size}
    store_np = {"colors": colors, "depths": depths, "est_c2w": kf_est,
                "gt_c2w": kf_gt, "count": 4, "est": est}
    packet = {"color_u8": pkt.color_u8,
              "depth_u16": pkt.depth_u16.astype(np.int64),
              "inv_q": pkt.depth_inv_q, "gt_c2w": pkt.gt_c2w, "idx": 4}
    outs = run_ranks(kf_frame_case, 2, doubled(cfg), spec, map_np(pair),
                     store_np, [packet], draws, iters, solver)
    for out in outs:
        assert out["left"] == 0
        assert out["counts"]["grad"]["calls"] == iters
        assert out["counts"].get("schur", {}).get("calls", 0) == (
            iters if solver == "schur" else 0)
        np.testing.assert_array_equal(out["est"], outs[0]["est"])
        np.testing.assert_array_equal(out["kf_est"], outs[0]["kf_est"])
    got = outs[0]
    np.testing.assert_allclose(got["losses"][0] / 2, np.asarray(jlosses),
                               rtol=1e-5)
    assert_map(got["map"], jms)
    np.testing.assert_allclose(got["est"][0], np.asarray(jest), atol=1e-5)
    np.testing.assert_allclose(got["kf_est"][0], np.asarray(jkf_est),
                               atol=1e-5)
    assert np.abs(got["est"][0][4] - est[4]).max() > 1e-5
    # Each rank holds its own three slots, the admitted frame in rank 1's.
    for out in outs:
        lo = out["slot_offset"]
        np.testing.assert_array_equal(out["colors"],
                                      np.asarray(jcolors)[lo:lo + 3])
        np.testing.assert_allclose(out["depths"],
                                   np.asarray(jdepths)[lo:lo + 3], rtol=1e-6)
