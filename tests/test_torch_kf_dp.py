"""Keyframe-sharded BA composed with ray DP (``parallel: {kf_shards: K,
devices: D}``) on 4 gloo ranks against the JAX package's composed
``('kf', 'dp')`` mesh on 4 of the virtual CPU devices, and the parallel
settings the port refuses.

One 4-rank gang runs ``make_kf_frame_mapper(dp=2)`` on a 2 x 2 grid
(rank r the kf row r // 2 and dp column r % 2), once per pose solver
(adam, schur), against JAX's ``make_kf_frame_mapper`` on the 2 x 2 mesh
(``distributed_ba.py:378-725``): frame 4 mapped with joint poses on a
trained map, a 6-slot store of 3 slots per kf row, admission into slot
4, which row 1 holds.  Every rank replays the selector's draws and per
iteration the (kf, dp) grid's folded pixel draws stacked in rank order
(``distributed_ba.py:110-112``) and its own renderer draws.

JAX's composed step reduces every loss and gradient over both axes
inside and outside the differentiated loss, so it takes K * D = 4 times
the global gradient (ROADMAP R5 with R = 4; measured here: with the
one-axis case's factor of 2, 105 of 6,864 SDF atlas entries fall outside
the tolerance after three Adam steps); the port's all-reduce gives the
exact global gradient.  So the port runs with every
mapping loss weight times 4 and its losses are divided by 4.  Tolerances
are test_torch_parallel_ba.py's: losses rtol 1e-5, poses atol 1e-5, the
map as ``assert_map``.
"""

import copy
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.engine import keyframes as jkf
from myslam_tpu.parallel import distributed_ba as jdba
from myslam_torch.engine.scheduler import SLAMSystem
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
from test_torch_parallel import LOSS_WEIGHTS, assert_map, fresh, map_np, \
    spec_of
from test_torch_slice import Pair, render_draws, selector_draws, small_cfg
from torch_gang import each, kfdp_frame_case, run_ranks

torch.set_num_threads(2)  # several test workers share the CPU

K, D = 2, 2
CAP, WINDOW = 6, 3
FACTOR = K * D  # JAX's composed step takes K * D times the gradient


@pytest.fixture(autouse=True)
def _scatter_route(monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)


def scaled(cfg, factor):
    out = copy.deepcopy(cfg)
    for k in LOSS_WEIGHTS:
        out["mapping"][k] = factor * float(out["mapping"][k])
    return out


def jax_case(pair, cfg, inputs, solver, iters, key):
    """JAX's composed mapper on the 2 x 2 mesh, and the port's draws."""
    colors, depths, kf_est, kf_gt, est, pkt = inputs
    w_max = WINDOW + 2
    mesh = Mesh(np.array(jax.devices()[:K * D]).reshape(K, D), ("kf", "dp"))
    jsel = jkf.make_window_selector(pair.jcam, CAP, WINDOW, w_max, CAP - 1)
    jmap = jdba.make_kf_frame_mapper(cfg, pair.jscene, pair.jcam, jsel,
                                     w_max, CAP - 1, mesh, importance=False,
                                     pose_solver=solver)
    opt_buf = jmap.jit_init({"map": fresh(pair),
                             "poses": jnp.zeros((w_max, 7), jnp.float32)})
    sh = NamedSharding(mesh, P("kf"))
    (jms, _, jest, jkf_est, _, jcolors, _, jlosses) = jmap(
        fresh(pair), opt_buf, jnp.asarray(est), jnp.asarray(kf_est),
        jnp.asarray(kf_gt), jax.device_put(jnp.asarray(colors), sh),
        jax.device_put(jnp.asarray(depths), sh), jnp.asarray(pkt.color_u8),
        jnp.asarray(pkt.depth_u16), pkt.depth_inv_q,
        jnp.asarray(pkt.gt_c2w), 4, 4, key, iters=iters, lr_factor=1.0,
        joint_opt=True, admit=True)
    n_local = int(cfg["mapping"]["pixels"]) // (K * D)
    draws = [np.asarray(d) for d in selector_draws(
        jax.random.fold_in(key, 0x7FFFFFFF), pair.jcam, CAP)]
    for it in range(iters):
        k_ray, k_z = jax.random.split(jax.random.fold_in(key, it))
        keys = [jax.random.split(jax.random.fold_in(
            jax.random.fold_in(k_ray, kf), dp))
            for kf in range(K) for dp in range(D)]
        draws += [np.stack([np.asarray(jax.random.randint(
            ki, (n_local,), 0, pair.jcam.W)) for ki, _ in keys]),
                  np.stack([np.asarray(jax.random.randint(
                      kj, (n_local,), 0, pair.jcam.H)) for _, kj in keys])]
        draws += [np.asarray(d) for d in render_draws(
            k_z, n_local, pair.jscene, False)]
    ref = {"losses": np.asarray(jlosses), "est": np.asarray(jest),
           "kf_est": np.asarray(jkf_est), "colors": np.asarray(jcolors)}
    return jms, ref, draws


def trained(pair, colors, depths, kf_est, iters=60):
    """The map after ``iters`` steps of the port's bare mapper over four
    keyframes (a well-posed start for the pose solve), in both
    packages: the JAX map is the port's, converted."""
    from myslam_tpu.models.planes import MapState as JMapState
    from myslam_torch.core.quaternion import matrix_to_cam_pose as t_m2p
    from myslam_torch.core.sampling import TorchDraws
    from myslam_torch.engine.mapper import make_mapper
    from myslam_torch.models.convert import to_jax_numpy

    step = make_mapper(pair.cfg, pair.scene, pair.cam, importance=False)
    step(pair.ms, t_m2p(torch.as_tensor(kf_est[:4])), torch.zeros((4,)),
         torch.arange(4), 4, torch.as_tensor(colors), torch.as_tensor(depths),
         TorchDraws(99, "cpu"), iters=iters, lr_factor=1.0)
    tree = to_jax_numpy(pair.ms)
    pair.jms = JMapState(
        sdf_atlas=jnp.asarray(tree["sdf_atlas"]),
        color_atlas=jnp.asarray(tree["color_atlas"]),
        decoder=jax.tree_util.tree_map(jnp.asarray, tree["decoder"]))


CASES = (("adam", 3), ("schur", 1))


@pytest.fixture(scope="module")
def gang():
    """Both solvers: JAX's composed mapper on the 2 x 2 mesh and the
    port's on one 4-rank gang, from one trained map.  Returns, by
    solver, JAX's map and records, the ranks' outputs and the frame's
    starting trajectory."""
    monkey = pytest.MonkeyPatch()
    monkey.setattr(jps, "ONEHOT_MAX_ROWS", 0)
    try:
        cfg = small_cfg(perturb=True)
        pair = Pair(cfg)
        cam = pair.cam
        rng = np.random.default_rng(2)
        colors = np.zeros((CAP, cam.H, cam.W, 3), np.float16)
        depths = np.zeros((CAP, cam.H, cam.W), np.float32)
        kf_est = np.tile(np.eye(4, dtype=np.float32), (CAP, 1, 1))
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
        trained(pair, colors, depths, kf_est)
        jax_side = {solver: jax_case(
            pair, cfg, (colors, depths, kf_est, kf_gt, est, pkt), solver,
            iters, jax.random.PRNGKey(12)) for solver, iters in CASES}
    finally:
        monkey.undo()
    store_np = {"colors": colors, "depths": depths, "est_c2w": kf_est,
                "gt_c2w": kf_gt, "count": 4, "est": est}
    packet = {"color_u8": pkt.color_u8,
              "depth_u16": pkt.depth_u16.astype(np.int64),
              "inv_q": pkt.depth_inv_q, "gt_c2w": pkt.gt_c2w, "idx": 4}
    ranks = run_ranks(each, K * D, [
        (kfdp_frame_case, (scaled(cfg, FACTOR), spec_of(pair), map_np(pair),
                           store_np, packet, jax_side[solver][2], iters,
                           solver, (K, D), CAP, WINDOW))
        for solver, iters in CASES], timeout=240)
    return {solver: {"jms": jax_side[solver][0], "ref": jax_side[solver][1],
                     "ranks": [rank[k] for rank in ranks], "est": est}
            for k, (solver, _) in enumerate(CASES)}


@pytest.mark.parametrize("solver, iters", CASES)
def test_kf_dp_frame_mapper_matches_jax(solver, iters, gang):
    """The composed frame mapper with pose solver ``solver`` on a 4-rank
    gang (one for both solvers) against JAX's on the 2 x 2 mesh."""
    jms, ref, ranks, est = (gang[solver][k] for k in ("jms", "ref",
                                                      "ranks", "est"))
    for r, out in enumerate(ranks):
        assert out["left"] == 0
        assert out["counts"]["grad"]["calls"] == iters
        assert out["counts"].get("schur", {}).get("calls", 0) == (
            iters if solver == "schur" else 0)
        for k in ("est", "kf_est", "losses"):
            np.testing.assert_array_equal(out[k], ranks[0][k])
        # Each kf row's two columns hold its three slots, the admitted
        # frame in row 1's.
        assert out["slot_offset"] == (r // D) * 3
        np.testing.assert_array_equal(
            out["colors"], ref["colors"][out["slot_offset"]:][:3])
    got = ranks[0]
    np.testing.assert_allclose(got["losses"] / FACTOR, ref["losses"],
                               rtol=1e-5)
    assert_map(got["map"], jms)
    np.testing.assert_allclose(got["est"], ref["est"], atol=1e-5)
    np.testing.assert_allclose(got["kf_est"], ref["kf_est"], atol=1e-5)
    assert np.abs(got["est"][4] - est[4]).max() > 1e-5


REFUSED = [
    ({"pipeline": True, "devices": 2}, None, "parallel.pipeline is its own"),
    ({"map_shards": 2, "devices": 2}, None, "map_shards composes with"),
    ({"map_shards": 2, "kf_shards": 2}, None, "map_shards composes with"),
    ({"kf_shards": 2, "devices": 2}, None,
     "kf_shards x parallel.devices (2 x 2) needs a process group of 4"),
    ({"pipeline": True, "pipeline_track_devices": 2}, None,
     "parallel.pipeline (2 tracking rank(s), the rest mapping) needs a "
     "process group of 3"),
    ({"dp_impl": "spmd", "zero_opt": True}, None, None),
    ({"kf_shards": 2}, "host_staged", "host_staged composes with ray DP"),
    ({"map_shards": 2}, "host_staged", "host_staged composes with ray DP"),
    ({"pipeline": True}, "host_staged", "host_staged composes with ray DP"),
]


@pytest.mark.parametrize("parallel, store, message", REFUSED)
def test_refuses_what_jax_refuses(parallel, store, message):
    """Each combination the JAX package's scheduler refuses
    (``scheduler.py:179-199``, ``:270-277``, ``:350-356``) raises a
    ValueError naming it in a process group of one.  ``dp_impl: spmd``
    with ``zero_opt`` (``message`` None) runs there: the unsharded
    plan."""
    cfg = load_config("configs/Synthetic/room_smoke.yaml", DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = 2
    cfg["parallel"].update(parallel)
    if store:
        cfg["keyframe_device"] = store
    if message is None:
        slam = SLAMSystem(cfg, output=tempfile.mkdtemp(), device="cpu")
        assert slam.plan == {"mode": None, "spmd": False,
                             "zero_opt": False}
        return
    with pytest.raises(ValueError) as err:
        SLAMSystem(cfg, output=tempfile.mkdtemp(), device="cpu")
    assert message in str(err.value)


def test_one_process_runs_the_pipeline_schedule():
    """``pipeline: true`` with one tracking rank and the rest mapping is
    accepted in a process group of one: one process plays both roles."""
    cfg = load_config("configs/Synthetic/room_smoke.yaml", DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = 2
    cfg["parallel"].update(pipeline=True)
    slam = SLAMSystem(cfg, output=tempfile.mkdtemp(), device="cpu")
    assert slam.parallel == "pipeline" and slam.pipe.local
    assert slam.pipe.is_track and slam.pipe.is_map
    assert os.path.isdir(slam.output)
