"""The port's ray-DP mapper and sharded tracker on 2 gloo ranks against
the JAX package's on 2 of the virtual CPU devices (conftest), the
parallel settings the port refuses and the plan it reads from
``parallel``; keyframe-sharded BA is held in test_torch_parallel_ba.py,
``dp_impl: spmd`` in test_torch_dp_spmd.py and the host-staged store
under ray DP in test_torch_dp_host.py, with the helpers and rules of
this file.

The port's cases run on one gang of two spawned CPU ranks (``gang``,
shared by the module; ``tests/torch_gang.py``, a wall-clock limit per
gang) with JAX's draws
replayed: every rank replays the same list, built from JAX's own key
splits -- the whole padded ray batch and the local batch's renderer
draws for ray DP (``mapper.py:176-199``), the global batch's jitter for
the sharded tracker (``tracker.py:132``), and for keyframe-sharded BA
each shard's folded pixel draws stacked into the (ranks, rays) draw that
every port rank makes (``distributed_ba.py:98-112``), for its frame
mapper after the window selector's draws.  The same map (converted from
JAX's) and the same imagery go into both; the keyframe-sharded cases
start from a map trained at the window's poses.

JAX's shard_map steps (``make_mapper(dp_mesh=...)``,
``make_distributed_ba``, ``make_kf_frame_mapper``) take R times the
global gradient on R devices: their masked means psum inside the
differentiated loss under ``check_vma=False``, whose transpose sums the
cotangents once more, and the explicit psum of the gradients then adds R
copies of the global one. Adam is invariant to that scale but for its
eps, so JAX's 2-device step equals its single-device step with every
mapping loss weight doubled (measured 7e-9 on the SDF atlas) and differs
from the undoubled one by up to 2.2e-3 on the few atlas entries whose
gradient is near eps. The port's all-reduce gives the exact global
gradient. So each test holds the port with the weights doubled
(``doubled``, its losses halved) against JAX's 2-device step, and, where
the draws allow, the port's own step against JAX's single-device one.

Tolerances, with their reason: float sums over ranks run in gloo's order
and XLA's in another, so nothing is bit-exact against JAX.  Losses
rtol 1e-5 and poses atol 1e-5 (three Adam steps; the pose lr is 0.001);
the decoders and color atlas atol 1e-4, the SDF atlas 5e-4 (Adam divides
a near-cancelling gradient entry by its own size, see
test_torch_slice.py); the reduced pose system within 1e-4 of its
largest entry.  The port's 2 ranks against its own single rank on the
same batch (no jitter, so no draw depends on the batch shape): losses
rtol 1e-6, map and poses atol 1e-6 (the two partial sums reassociate
once).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.core.quaternion import matrix_to_cam_pose
from myslam_tpu.engine import mapper as jmapper
from myslam_tpu.engine import tracker as jtracker
from myslam_torch.core.sampling import ReplayDraws
from myslam_torch.engine import mapper as tmapper
from myslam_torch.engine import tracker as ttracker
from myslam_torch.engine.scheduler import SLAMSystem
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
from test_torch_slice import Pair, render_draws, small_cfg
from torch_gang import each, gather_store_case, mapper_case, run_ranks, \
    tracker_case

torch.set_num_threads(2)  # several test workers share the CPU

ITERS = 3
LOSS_WEIGHTS = ("w_sdf_fs", "w_sdf_center", "w_sdf_tail", "w_color",
                "w_depth")


def doubled(cfg):
    """cfg with every mapping loss weight doubled: the port's step then
    takes the gradient that JAX's 2-device shard_map step takes (see the
    module's docstring), and its losses are twice JAX's, exactly."""
    out = copy.deepcopy(cfg)
    for k in LOSS_WEIGHTS:
        out["mapping"][k] = 2.0 * float(out["mapping"][k])
    return out


@pytest.fixture(autouse=True)
def _scatter_route(monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)


def mesh(axis):
    return Mesh(np.array(jax.devices()[:2]), (axis,))


def spec_of(pair, importance=False, exact_color=False):
    """The scene as plain values the ranks rebuild it from."""
    cfg = pair.cfg
    r = cfg["rendering"]
    sc = pair.scene
    return {"bound": np.asarray(sc.bound, np.float32),
            "c_dim": int(cfg["model"]["c_dim"]),
            "sdf_res": [cfg["planes_res"]["coarse"],
                        cfg["planes_res"]["fine"]],
            "color_res": [cfg["c_planes_res"]["coarse"],
                          cfg["c_planes_res"]["fine"]],
            "truncation": sc.truncation,
            "n_stratified": int(r["n_stratified"]),
            "n_importance": int(r["n_importance"]),
            "perturb": bool(r["perturb"]),
            "color_topk": int(r["color_topk"]),
            "importance": importance, "exact_color": exact_color}


def map_np(pair):
    """JAX's map as plain numpy dicts (no JAX types cross to the ranks)."""
    tree = jax.tree_util.tree_map(np.array, pair.jms)
    return {"sdf_atlas": tree.sdf_atlas, "color_atlas": tree.color_atlas,
            "decoder": tree.decoder}


def fresh(pair):
    """A copy of JAX's map for a step that donates (consumes) it."""
    return jax.tree_util.tree_map(jnp.copy, pair.jms)


def window(pair, cap=4):
    """Three keyframes (frames 0, 2, 4, poses jittered) in a 4-slot
    store; the window: slots 0, 1, 2, the oldest pose frozen."""
    rng = np.random.default_rng(1)
    cam = pair.cam
    colors = np.zeros((cap, cam.H, cam.W, 3), np.float16)
    depths = np.zeros((cap, cam.H, cam.W), np.float32)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    for s, f in enumerate((0, 2, 4)):
        c, d, gt = pair.dataset.get_frame(f)
        colors[s], depths[s], c2ws[s] = c, d, gt
        c2ws[s, :3, 3] += rng.normal(scale=0.004, size=3)
    poses = np.asarray(matrix_to_cam_pose(jnp.asarray(c2ws)))
    return {"poses": poses, "pose_mask": np.array([0, 1, 1, 0], np.float32),
            "slot_kf": np.array([0, 1, 2, 0], np.int64), "n_slots": 3,
            "kf_colors": colors, "kf_depths": depths}


def assert_map(got, jms, atol=1e-4, sdf_atol=5e-4, color_atol=None):
    np.testing.assert_allclose(got["sdf_atlas"], np.asarray(jms.sdf_atlas),
                               atol=sdf_atol, rtol=0)
    np.testing.assert_allclose(
        got["color_atlas"], np.asarray(jms.color_atlas),
        atol=atol if color_atol is None else color_atol, rtol=0)
    for g, r in zip(jax.tree_util.tree_leaves(got["decoder"]),
                    jax.tree_util.tree_leaves(jms.decoder)):
        np.testing.assert_allclose(g, np.asarray(r), atol=atol, rtol=0)


def dp_draws(key, n_rays, ranks, pair, importance):
    """JAX's ray-DP draws: the whole padded batch, then each shard's
    renderer draws at the local batch shape (the same on every shard)."""
    rows = -(-n_rays // ranks)
    out = []
    for it in range(ITERS):
        k_px, k_render = jax.random.split(jax.random.fold_in(key, it))
        ki, kj = jax.random.split(k_px)
        out += [np.asarray(jax.random.randint(ki, (rows * ranks,), 0,
                                              pair.jcam.W)),
                np.asarray(jax.random.randint(kj, (rows * ranks,), 0,
                                              pair.jcam.H)),
                *map(np.asarray, render_draws(k_render, rows, pair.jscene,
                                              importance))]
    return out


def grad_bytes(pair):
    ms = pair.ms
    n = (ms.sdf_atlas.numel() + ms.color_atlas.numel()
         + sum(p.numel() for p in ms.decoder.mlp_params())
         + ms.decoder.beta.numel() + 4 * 7)
    return 4 * n


# -- the port's 2-rank cases, on one gang -------------------------------------

def dp_case(case):
    """test_dp_mapper_matches_jax's case: the config, the pair, the
    window, the key, the draws and the port's cases (the weights
    doubled; for ``exact`` also as they are)."""
    jitter = case == "jitter_pad"
    cfg = small_cfg(perturb=jitter)
    cfg["mapping"]["pixels"] = 125 if jitter else 128
    pair = Pair(cfg)
    win = window(pair)
    key = jax.random.PRNGKey(4)
    draws = dp_draws(key, int(cfg["mapping"]["pixels"]), 2, pair, jitter)
    spec = spec_of(pair, importance=jitter)
    cases = [(mapper_case, (doubled(cfg), spec, map_np(pair), win, draws,
                            ITERS, True))]
    if not jitter:
        cases.append((mapper_case, (cfg, spec, map_np(pair), win, draws,
                                    ITERS, True)))
    return {"cfg": cfg, "pair": pair, "win": win, "key": key,
            "spec": spec, "cases": cases}


def track_case():
    """test_sharded_tracker_matches_jax's case."""
    cfg = small_cfg(perturb=True)
    pair = Pair(cfg)
    pkt = pair.packet(3, need_full=False)
    pose_init = np.asarray(matrix_to_cam_pose(
        jnp.asarray(pair.dataset.poses[2][None])))[0]
    key = jax.random.PRNGKey(6)
    iters, n = pkt.px_i.shape
    draws = [np.asarray(d) for it in range(iters) for d in render_draws(
        jax.random.fold_in(key, it), n, pair.jscene, False)]
    inputs = {"pose_init": pose_init, "px_i": pkt.px_i.astype(np.int64),
              "px_j": pkt.px_j.astype(np.int64), "px_color": pkt.px_color,
              "px_depth": pkt.px_depth}
    return {"cfg": cfg, "pair": pair, "pkt": pkt, "pose_init": pose_init,
            "key": key, "cases": [(tracker_case, (cfg, spec_of(pair),
                                                  map_np(pair), inputs,
                                                  draws))]}


@pytest.fixture(scope="module")
def gang():
    """The port's sides of the ray-DP mapper, the sharded tracker and the
    rank-0 gather on one gang of 2 ranks: each case's inputs and its
    per-rank outputs (``outs``: a list per case, rank by rank)."""
    monkey = pytest.MonkeyPatch()
    monkey.setattr(jps, "ONEHOT_MAX_ROWS", 0)
    try:
        cases = {"jitter_pad": dp_case("jitter_pad"),
                 "exact": dp_case("exact"), "track": track_case(),
                 "store": {"cases": [(gather_store_case, (6, 8, 4, packed))
                                     for packed in (False, True)]}}
    finally:
        monkey.undo()
    flat = [(name, c) for name in cases for c in cases[name]["cases"]]
    ranks = run_ranks(each, 2, [c for _, c in flat], timeout=240)
    for name in cases:
        idx = [k for k, (n, _) in enumerate(flat) if n == name]
        cases[name]["outs"] = [[rank[k] for k in idx] for rank in ranks]
    return cases


# -- engine/mapper.py: ray data parallelism ----------------------------------

@pytest.mark.parametrize("case", ["jitter_pad", "exact"])
def test_dp_mapper_matches_jax(case, gang):
    """make_mapper on 2 ranks with the weights doubled against JAX's
    make_mapper(dp_mesh=...) on 2 devices.  ``jitter_pad``: 125 rays
    (one padded tail ray), jitter and the importance branch (JAX's
    renderer draws then depend on the local batch shape, so there is no
    single-device twin); ``exact``: 128 rays, no jitter, and the port's
    own 2 ranks also against JAX's single device and the port's single
    rank.  Each iteration makes one gradient all-reduce of the whole flat
    gradient and one of the loss sums."""
    jitter = case == "jitter_pad"
    c = gang[case]
    cfg, pair, win, key = c["cfg"], c["pair"], c["win"], c["key"]

    def jax_step(dp_mesh):
        step = jmapper.make_mapper(cfg, pair.jscene, pair.jcam,
                                   importance=jitter, dp_mesh=dp_mesh)
        return step(fresh(pair), jnp.asarray(win["poses"]),
                    jnp.asarray(win["pose_mask"]),
                    jnp.asarray(win["slot_kf"], jnp.int32), jnp.int32(3),
                    jnp.asarray(win["kf_colors"]),
                    jnp.asarray(win["kf_depths"]), key, iters=ITERS,
                    lr_factor=1.0)

    outs = c["outs"]
    for out in outs:
        for res in out:
            assert res["left"] == 0
            assert res["counts"]["grad"] == {
                "calls": ITERS, "bytes": ITERS * grad_bytes(pair),
                "seconds": res["counts"]["grad"]["seconds"]}
            assert res["counts"]["loss"]["calls"] == ITERS
        for res, res0 in zip(out, outs[0]):
            np.testing.assert_array_equal(res["losses"], res0["losses"])
            np.testing.assert_array_equal(res["poses"], res0["poses"])
    got = outs[0][0]
    jms, jposes, jlosses = jax_step(mesh("dp"))
    np.testing.assert_allclose(got["losses"] / 2, np.asarray(jlosses),
                               rtol=1e-5)
    np.testing.assert_allclose(got["poses"], np.asarray(jposes), atol=1e-5)
    assert_map(got["map"], jms)
    assert np.abs(got["poses"] - win["poses"]).max() > 1e-5
    if jitter:
        return
    got = outs[0][1]
    jms, jposes, jlosses = jax_step(None)
    np.testing.assert_allclose(got["losses"], np.asarray(jlosses), rtol=1e-5)
    np.testing.assert_allclose(got["poses"], np.asarray(jposes), atol=1e-5)
    assert_map(got["map"], jms)
    one = mapper_case(cfg, c["spec"], map_np(pair), win,
                      dp_draws(key, 128, 1, pair, False), ITERS, False)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-6)
    np.testing.assert_allclose(got["poses"], one["poses"], atol=1e-6)
    for k in ("sdf_atlas", "color_atlas"):
        np.testing.assert_allclose(got["map"][k], one["map"][k], atol=1e-6)


def test_single_rank_mapper_is_the_unsharded_path():
    """sharded=True on one rank (no process group) is the unsharded
    mapper, bit for bit."""
    cfg = small_cfg(perturb=True)
    pair = Pair(cfg)
    win = window(pair)
    draws = dp_draws(jax.random.PRNGKey(2), 128, 1, pair, False)
    spec = spec_of(pair)
    a = mapper_case(cfg, spec, map_np(pair), win, draws, ITERS, True)
    b = mapper_case(cfg, spec, map_np(pair), win, draws, ITERS, False)
    np.testing.assert_array_equal(a["losses"], b["losses"])
    np.testing.assert_array_equal(a["poses"], b["poses"])
    np.testing.assert_array_equal(a["map"]["sdf_atlas"],
                                  b["map"]["sdf_atlas"])
    assert a["counts"] == {}


# -- engine/tracker.py: the pixel batch split over ranks ----------------------

def test_sharded_tracker_matches_jax(gang):
    """make_tracker on 2 ranks against JAX's make_tracker with the pixel
    batch sharded over 2 devices: per iteration one all-gather of the
    depth errors, one all-reduce of the loss sums, one of the 7-float
    gradient; the ranks agree bit for bit."""
    c = gang["track"]
    cfg, pair, pkt, pose_init = c["cfg"], c["pair"], c["pkt"], \
        c["pose_init"]
    jtrack = jtracker.make_tracker(
        cfg, pair.jscene, pair.jcam,
        ray_sharding=NamedSharding(mesh("dp"), P("dp")))
    jbest, jlosses, jiter = jtrack(pair.jms, pose_init, pkt.px_i, pkt.px_j,
                                   pkt.px_color, pkt.px_depth, c["key"])
    iters = pkt.px_i.shape[0]
    outs = [out[0] for out in c["outs"]]
    for out in outs:
        assert out["left"] == 0
        for kind in ("track_grad", "track_loss", "track_median"):
            assert out["counts"][kind]["calls"] == iters, kind
        assert out["counts"]["track_grad"]["bytes"] == iters * 7 * 4
        np.testing.assert_array_equal(out["best"], outs[0]["best"])
    np.testing.assert_allclose(outs[0]["losses"], np.asarray(jlosses),
                               rtol=1e-4)
    np.testing.assert_allclose(outs[0]["iter_poses"], np.asarray(jiter),
                               atol=1e-4)
    np.testing.assert_allclose(outs[0]["best"], np.asarray(jbest),
                               atol=1e-4)
    assert np.abs(outs[0]["best"] - pose_init).max() > 1e-4


def test_frame_tracker_matches_jax():
    """make_frame_tracker (one process) against JAX's: frame 3 from the
    constant-speed start off frames 1 and 2, the trajectory row written,
    the first and best losses and each iteration's pose."""
    cfg = small_cfg(perturb=True)
    pair = Pair(cfg)
    pkt = pair.packet(3, need_full=False)
    est = np.stack([pair.dataset.poses[f] for f in range(5)]).astype(
        np.float32)
    est[3:] = np.eye(4, dtype=np.float32)
    key = jax.random.PRNGKey(7)
    jtrack = jtracker.make_frame_tracker(cfg, pair.jscene, pair.jcam)
    jest, jc2w, jfirst, jbest, jiter = jtrack(
        pair.jms, jnp.asarray(est), 3, pkt.px_i, pkt.px_j, pkt.px_color,
        pkt.px_depth, key)
    iters, n = pkt.px_i.shape
    draws = ReplayDraws([np.asarray(d) for it in range(iters)
                         for d in render_draws(jax.random.fold_in(key, it),
                                               n, pair.jscene, False)])
    t_est = torch.as_tensor(est)
    track = ttracker.make_frame_tracker(cfg, pair.scene, pair.cam)
    c2w, first, best, iter_poses = track(
        pair.ms, t_est, 3, torch.as_tensor(pkt.px_i.astype(np.int64)),
        torch.as_tensor(pkt.px_j.astype(np.int64)),
        torch.as_tensor(pkt.px_color), torch.as_tensor(pkt.px_depth), draws)
    assert len(draws) == 0
    np.testing.assert_allclose(float(first), float(jfirst), rtol=1e-4)
    np.testing.assert_allclose(float(best), float(jbest), rtol=1e-4)
    np.testing.assert_allclose(iter_poses.numpy(), np.asarray(jiter),
                               atol=1e-4)
    np.testing.assert_allclose(c2w.numpy(), np.asarray(jc2w), atol=1e-4)
    np.testing.assert_array_equal(t_est[3].numpy(), c2w.numpy())
    np.testing.assert_allclose(t_est.numpy(), np.asarray(jest), atol=1e-4)


# -- engine/scheduler.py: what the port refuses -------------------------------

@pytest.mark.parametrize("parallel, names", [
    ({"map_shards": 2}, "parallel.map_shards"),
    ({"pipeline": True, "devices": 2}, "parallel.pipeline"),
    ({"kf_shards": 2, "devices": 2}, "kf_shards x parallel.devices"),
    ({"dp_impl": "spmd"}, None),
    ({"devices": 2}, "parallel.devices (dp, 2 rank(s))"),
    ({"kf_shards": 2}, "parallel.kf_shards (kf, 2 rank(s))"),
])
def test_scheduler_refuses_what_it_does_not_run(tmp_path, parallel, names):
    """The pipeline combined with ray DP, which the JAX package refuses,
    and map_shards, kf x dp, devices or kf_shards of 2 without a process
    group of their rank count, raise a ValueError naming the mode instead
    of running on one device (test_torch_kf_dp.py has the other
    refusals).  ``dp_impl: spmd`` alone (``names`` None) runs: on one
    rank it is the unsharded plan."""
    cfg = load_config("configs/Synthetic/room_smoke.yaml", DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = 2
    cfg["parallel"].update(parallel)
    if names is None:
        slam = SLAMSystem(cfg, output=str(tmp_path), device="cpu")
        assert slam.plan == {"mode": None, "spmd": False,
                             "zero_opt": False}
        return
    with pytest.raises(ValueError) as err:
        SLAMSystem(cfg, output=str(tmp_path), device="cpu")
    assert names in str(err.value)


@pytest.mark.parametrize("parallel, world, store, plan", [
    ({"devices": 2, "dp_impl": "spmd"}, 2, None,
     {"mode": "dp", "spmd": True, "zero_opt": True}),
    ({"devices": 0, "dp_impl": "SPMD", "zero_opt": False}, 2, None,
     {"mode": "dp", "spmd": True, "zero_opt": False}),
    ({"devices": 2}, 2, None, {"mode": "dp", "spmd": False,
                               "zero_opt": False}),
    ({"devices": 2}, 2, "host_staged",
     {"mode": "dp", "spmd": True, "zero_opt": False}),
    ({"devices": 2, "dp_impl": "spmd"}, 2, "host",
     {"mode": "dp", "spmd": True, "zero_opt": True}),
    ({"pipeline": True, "dp_impl": "spmd"}, 3, None,
     {"mode": "pipeline", "track": 1, "map": 2, "spmd": True,
      "zero_opt": False}),
    ({"pipeline": True, "dp_impl": "spmd"}, 2, None,
     {"mode": "pipeline", "track": 1, "map": 1, "spmd": False,
      "zero_opt": False}),
    ({"kf_shards": 2, "devices": 2, "dp_impl": "spmd"}, 4, None,
     {"mode": "kfdp", "kf": 2, "dp": 2, "spmd": False, "zero_opt": False}),
    ({"kf_shards": 0, "dp_impl": "spmd"}, 2, None,
     {"mode": "kf", "spmd": False, "zero_opt": False}),
    ({"map_shards": 2, "dp_impl": "spmd"}, 2, None,
     {"mode": "map", "spmd": False, "zero_opt": False}),
    ({"devices": 2, "dp_impl": "pjit"}, 2, None, "parallel.dp_impl: pjit"),
])
def test_parallel_plan_reads_dp_impl(parallel, world, store, plan):
    """``parallel_plan``'s two facts for the mapper builders, by the JAX
    package's rules (``scheduler.py:225-258``): ray DP under ``dp_impl:
    spmd`` draws the global batch and row-shards Adam unless
    ``zero_opt`` is false; the pipeline's map role of two ranks draws
    the global batch with a replicated Adam; kf, kf x dp and map shards
    ignore ``dp_impl``; the host-staged store's window mapper draws the
    global batch under either impl.  Another ``dp_impl`` raises, naming
    it."""
    from myslam_torch.engine.scheduler import parallel_plan

    cfg = {"parallel": parallel}
    if store:
        cfg["keyframe_device"] = store
    if isinstance(plan, str):
        with pytest.raises(ValueError, match=plan):
            parallel_plan(cfg, world)
        return
    assert parallel_plan(cfg, world) == plan


def test_one_rank_has_no_collectives():
    """Without a process group the port runs as before: world 1, and the
    flat gradient all-reduce is a no-op."""
    from myslam_torch.parallel import distributed

    assert distributed.world() == 1 and distributed.rank() == 0
    assert distributed.host_shard(5) == (0, 5)
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    assert distributed.all_reduce_grads([p]) == 0
    assert torch.equal(p.grad, torch.full((3,), 2.0))
    assert tmapper.make_mapper  # the bare step exists without a group
    assert ReplayDraws([]) is not None


def test_sharded_store_gathers_to_rank0(gang):
    """``KeyframeStore.full_view`` of a store sharded over 2 ranks, float
    and packed: rank 0 gets every slot's imagery in slot order, one
    gather per buffer; rank 1 gets None (it allocates no copy)."""
    outs = gang["store"]["outs"]
    for n, buffers in enumerate((2, 3)):
        r0, r1 = outs[0][n], outs[1][n]
        assert r1["full"] is None
        assert len(r0["full"]) == buffers
        for got, a, b in zip(r0["full"], r0["mine"], r1["mine"]):
            np.testing.assert_array_equal(got, np.concatenate([a, b]))
        for out in (r0, r1):
            assert out["counts"]["store"]["calls"] == buffers
