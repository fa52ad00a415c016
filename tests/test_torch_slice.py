"""The port's renderer, tracker, keyframe selection and mapper against the
JAX package, and the slice as a whole: map frame 0, then track frame 1.

Both packages start from the same map (the JAX MapState converted with
``models.convert.from_jax_numpy``), read the same frame packets
(``myslam_tpu.utils.datasets.build_packet``), and the port replays the
draws JAX makes from its keys: the test repeats JAX's key splits
(``mapper.py:176-183``, ``renderer.py:173``, ``tracker.py:132``,
``keyframes.py:328,386``) to compute them.  The JAX atlas gradient goes
through its scatter (ONEHOT_MAX_ROWS = 0).  Sizes are small: a 24x32
camera, c_dim 8, coarse planes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.core.quaternion import matrix_to_cam_pose as j_m2p
from myslam_tpu.engine import keyframes as jkf
from myslam_tpu.engine import mapper as jmapper
from myslam_tpu.engine import tracker as jtracker
from myslam_tpu.engine.camera import Camera as JCamera
from myslam_tpu.engine.scheduler import compute_bound as j_compute_bound
from myslam_tpu.models.decoders import init_decoder_params
from myslam_tpu.models.planes import init_map_state as j_init_map_state
from myslam_tpu.models.planes import make_layout as j_make_layout
from myslam_tpu.render import renderer as jrend
from myslam_tpu.utils import datasets as jdata
from myslam_torch.core.quaternion import matrix_to_cam_pose
from myslam_torch.core.sampling import ReplayDraws
from myslam_torch.engine import keyframes as tkf
from myslam_torch.engine import mapper as tmapper
from myslam_torch.engine import tracker as ttracker
from myslam_torch.engine.camera import Camera
from myslam_torch.models.convert import from_jax_numpy, to_jax_numpy
from myslam_torch.models.planes import compute_bound, make_layout
from myslam_torch.render import renderer as trend
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

torch.set_num_threads(2)  # several test workers share the CPU

CAPACITY = 4  # keyframe slots; the last is the scratch slot


@pytest.fixture(autouse=True)
def _scatter_route(monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)


def small_cfg(perturb: bool):
    cfg = load_config("configs/Synthetic/room.yaml", DEFAULT_CONFIG)
    cfg["cam"].update(H=24, W=32, fx=20.0, fy=20.0, cx=15.5, cy=11.5)
    cfg["model"]["c_dim"] = 8
    cfg["planes_res"].update(coarse=0.48, fine=0.24)
    cfg["c_planes_res"].update(coarse=0.48, fine=0.12)
    cfg["tracking"].update(pixels=64, iters=8, ignore_edge_H=2,
                           ignore_edge_W=2, map_bf16=False)
    cfg["mapping"].update(pixels=128, iters=5, iters_first=5,
                          map_bf16=False)
    cfg["rendering"]["perturb"] = perturb
    cfg["data"]["n_frames"] = 5
    return cfg


class Pair:
    """One configuration built in both packages, from one JAX map."""

    def __init__(self, cfg, seed=0):
        self.cfg = cfg
        self.jcam = JCamera.from_cfg(cfg)
        self.cam = Camera.from_cfg(cfg)
        bound = compute_bound(cfg)
        np.testing.assert_array_equal(bound, j_compute_bound(cfg))
        c = cfg["model"]["c_dim"]
        pres, cres = cfg["planes_res"], cfg["c_planes_res"]
        r = cfg["rendering"]
        common = dict(
            bound=tuple(map(tuple, bound.tolist())),
            truncation=float(cfg["model"]["truncation"]),
            n_stratified=int(r["n_stratified"]),
            n_importance=int(r["n_importance"]),
            perturb=bool(r["perturb"]), color_topk=int(r["color_topk"]))
        jb = jnp.asarray(bound)
        self.jscene = jrend.SceneGeometry(
            sdf_layout=j_make_layout(jb, [pres["coarse"], pres["fine"]], c),
            color_layout=j_make_layout(jb, [cres["coarse"], cres["fine"]], c),
            **common)
        self.scene = trend.SceneGeometry(
            sdf_layout=make_layout(bound, [pres["coarse"], pres["fine"]], c),
            color_layout=make_layout(bound, [cres["coarse"], cres["fine"]],
                                     c),
            **common)
        self.jms = j_init_map_state(
            jax.random.PRNGKey(seed + 1), self.jscene.sdf_layout,
            self.jscene.color_layout,
            init_decoder_params(jax.random.PRNGKey(seed), c_dim=c))
        self.ms = from_jax_numpy(jax.tree_util.tree_map(np.array, self.jms))
        self.dataset = jdata.get_dataset(cfg)

    def packet(self, idx, need_full):
        t = self.cfg["tracking"]
        return jdata.build_packet(
            self.dataset, idx, iters=int(t["iters"]), n_px=int(t["pixels"]),
            ie_h=int(t["ignore_edge_H"]), ie_w=int(t["ignore_edge_W"]),
            need_full=need_full, seed=0)


def render_draws(key, n_rays, scene, importance):
    """What build_z_vals_core draws from ``key`` (renderer.py:173)."""
    k_surf, k_uni, k_pdf = jax.random.split(key, 3)
    if not scene.perturb and not importance:
        return []
    out = []
    if scene.perturb:
        out.append(jax.random.uniform(k_surf, (n_rays, scene.n_samples)))
    if importance:
        if scene.perturb:
            out.append(jax.random.uniform(k_uni, (n_rays, scene.n_stratified)))
        out.append(jax.random.uniform(k_pdf, (n_rays, scene.n_importance)))
    return out


def selector_draws(key, cam, capacity, num_rays=50):
    """make_window_selector's draws (keyframes.py:328,386)."""
    k_score, k_pick = jax.random.split(key)
    kj, ki = jax.random.split(k_score)
    return [jax.random.randint(kj, (num_rays,), 0, cam.H),
            jax.random.randint(ki, (num_rays,), 0, cam.W),
            jax.random.uniform(k_pick, (capacity,))]


def map_iteration_draws(key, it, n_rays, cam, scene, importance):
    """One mapping iteration's draws (mapper.py:176-183)."""
    k_px, k_render = jax.random.split(jax.random.fold_in(key, it))
    ki, kj = jax.random.split(k_px)
    return [jax.random.randint(ki, (n_rays,), 0, cam.W),
            jax.random.randint(kj, (n_rays,), 0, cam.H),
            *render_draws(k_render, n_rays, scene, importance)]


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def assert_map_close(port_ms, jms, atol, sdf_atol):
    got = to_jax_numpy(port_ms)
    np.testing.assert_allclose(got["sdf_atlas"], np.asarray(jms.sdf_atlas),
                               atol=sdf_atol, rtol=0)
    np.testing.assert_allclose(got["color_atlas"],
                               np.asarray(jms.color_atlas), atol=atol, rtol=0)
    for g, r in zip(jax.tree_util.tree_leaves(got["decoder"]),
                    jax.tree_util.tree_leaves(jms.decoder)):
        np.testing.assert_allclose(g, np.asarray(r), atol=atol, rtol=0)


# -- render/renderer.py ----------------------------------------------------------

@pytest.mark.parametrize("importance", [False, True])
def test_render_rays_and_gradients_match_jax(importance):
    """Depth-guided rays, and with ``importance`` also depth-less rays
    through the coarse pass and inverse-CDF samples; jittered z.
    Tolerance 1e-4: sums over 40 samples and, for the gradients, over all
    rays, in another order."""
    pair = Pair(small_cfg(perturb=True))
    rng = np.random.default_rng(0)
    R = 48
    c2w = np.asarray(pair.dataset.poses[2])
    i = rng.uniform(0, 32, R).astype(np.float32)
    j = rng.uniform(0, 24, R).astype(np.float32)
    depth = rng.uniform(0.8, 2.5, R).astype(np.float32)
    depth[::5] = 0.0
    key = jax.random.PRNGKey(7)
    from myslam_tpu.core.geometry import rays_from_uv as j_rays

    jro, jrd = j_rays(i, j, c2w, pair.jcam.fx, pair.jcam.fy, pair.jcam.cx,
                      pair.jcam.cy)

    def jloss(ms, ro, rd):
        d, c, s, z = jrend.render_rays(key, ms, pair.jscene, ro, rd,
                                       jnp.asarray(depth), importance)
        return (jnp.sum(d) + jnp.sum(c * c) + jnp.sum(s)), (d, c, s, z)

    (_, jout), (jg_ms, jg_ro, jg_rd) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(pair.jms, jro, jrd)

    ro = torch.tensor(np.asarray(jro), requires_grad=True)
    rd = torch.tensor(np.asarray(jrd), requires_grad=True)
    draws = ReplayDraws(render_draws(key, R, pair.jscene, importance))
    out = trend.render_rays(draws, pair.ms, pair.scene, ro, rd,
                            torch.tensor(depth), importance)
    assert len(draws) == 0
    d, c, s, z = out
    (d.sum() + (c * c).sum() + s.sum()).backward()
    for a, b in zip(out, jout):
        np.testing.assert_allclose(N(a), np.asarray(b), atol=1e-4, rtol=0)
    np.testing.assert_allclose(N(ro.grad), np.asarray(jg_ro), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(N(rd.grad), np.asarray(jg_rd), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(N(pair.ms.sdf_atlas.grad),
                               np.asarray(jg_ms.sdf_atlas), atol=1e-4)
    np.testing.assert_allclose(N(pair.ms.color_atlas.grad),
                               np.asarray(jg_ms.color_atlas), atol=1e-4)
    dec = pair.ms.decoder
    np.testing.assert_allclose(N(dec.sdf[0].weight.grad).T,
                               np.asarray(jg_ms.decoder["sdf"][0][0]),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(N(dec.beta.grad),
                               np.asarray(jg_ms.decoder["beta"]),
                               atol=1e-4, rtol=1e-5)


# -- engine/keyframes.py --------------------------------------------------------

def test_window_selector_matches_jax():
    """Overlap scores and the picked window on a store of 7 keyframes
    along the synthetic trajectory."""
    cfg = small_cfg(perturb=False)
    cfg["data"]["n_frames"] = 40
    # The scorer ignores a 20-pixel border: a camera wide enough for it.
    cfg["cam"].update(H=120, W=160, fx=100.0, fy=100.0, cx=79.5, cy=59.5)
    pair = Pair(cfg)
    cap, window, w_max = 10, 4, 6
    poses = np.stack([pair.dataset.poses[k] for k in range(0, 28, 4)])
    kf = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
    kf[:7] = poses
    _, depth, cur = pair.dataset.get_frame(30)
    key = jax.random.PRNGKey(11)
    jsel = jkf.make_window_selector(pair.jcam, cap, window, w_max, cap - 1)
    tsel = tkf.make_window_selector(pair.cam, cap, window, w_max, cap - 1)
    jscores = jkf.make_overlap_scorer(pair.jcam)(
        kf, 5, cur, depth, jax.random.split(key)[0])
    scores = tkf.make_overlap_scorer(pair.cam)(
        torch.tensor(kf), 5, torch.tensor(cur), torch.tensor(depth),
        ReplayDraws(selector_draws(key, pair.jcam, cap)[:2]))
    np.testing.assert_allclose(N(scores), np.asarray(jscores), atol=1e-6)
    assert (np.asarray(jscores)[:5] > 0).sum() >= 2  # a real choice
    for joint_opt in (0.0, 1.0):
        ref = jsel(kf, 7, cur, depth, key, joint_opt)
        got = tsel(torch.tensor(kf), 7, torch.tensor(cur),
                   torch.tensor(depth),
                   ReplayDraws(selector_draws(key, pair.jcam, cap)),
                   joint_opt)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(N(a), np.asarray(b))


# -- engine/tracker.py ----------------------------------------------------------

def test_group_tracker_matches_jax():
    """Two consecutive frames tracked as one group against a frozen map
    (const-speed init from the group's own poses), jittered z replayed.
    Tolerance 1e-4 on poses and losses: eight Adam steps of a 7-dof pose
    whose gradient sums 64 rays x 40 samples in another order."""
    cfg = small_cfg(perturb=True)
    pair = Pair(cfg)
    pkts = [pair.packet(k, need_full=False) for k in (2, 3)]
    est = np.stack([pair.dataset.poses[k] for k in range(5)])
    key = jax.random.PRNGKey(5)

    def stack(name):
        return np.stack([getattr(p, name) for p in pkts])

    jgroup = jtracker.make_group_tracker(cfg, pair.jscene, pair.jcam, 2)
    jest, jc2ws, jfirst, jbest, jiter = jgroup(
        pair.jms, jnp.asarray(est), jnp.int32(2), stack("px_i"),
        stack("px_j"), stack("px_color"), stack("px_depth"), key)

    draws = []
    for idx in (2, 3):
        fkey = jax.random.fold_in(key, idx)
        for it in range(8):
            draws += render_draws(jax.random.fold_in(fkey, it), 64,
                                  pair.jscene, False)
    replay = ReplayDraws(draws)
    test = torch.tensor(est)
    tgroup = ttracker.make_group_tracker(cfg, pair.scene, pair.cam)
    c2ws, first, best, iter_poses = tgroup(
        pair.ms, test, 2, torch.tensor(stack("px_i").astype(np.int64)),
        torch.tensor(stack("px_j").astype(np.int64)),
        torch.tensor(stack("px_color")), torch.tensor(stack("px_depth")),
        replay)
    assert len(replay) == 0
    np.testing.assert_allclose(N(c2ws), np.asarray(jc2ws), atol=1e-4)
    np.testing.assert_allclose(N(test), np.asarray(jest), atol=1e-4)
    np.testing.assert_allclose(N(first), np.asarray(jfirst), rtol=1e-4)
    np.testing.assert_allclose(N(best), np.asarray(jbest), rtol=1e-4)
    np.testing.assert_allclose(N(iter_poses), np.asarray(jiter), atol=1e-4)


# -- the slice: engine/mapper.py then engine/tracker.py -------------------------

def test_slice_map_frame0_then_track_frame1_matches_jax():
    """Frame 0 mapped for 5 iterations (selection, iterations, pose
    write-back, admission), then frame 1 tracked for 8 iterations against
    the map each package just built; perturb off, f32 quads.

    Tolerances, measured on this case and stated with their reason:
    the per-iteration mapping and tracking losses within rtol 1e-4
    (measured 4e-6 and 9e-6); the keyframe store and trajectory within
    1e-6 (measured exact); the tracked poses within 1e-4 (measured
    5e-6); the color atlas and decoder within 1e-4 (measured 6e-6); the
    SDF atlas after 5 Adam steps at lr 0.025 (planes_lr 0.005 x
    lr_first_factor 5) within 5e-4 (measured 3.3e-4 on 17 of 6,864
    entries, 1.3 % of one step) -- Adam divides each gradient by its own
    running magnitude, so an entry whose gradient is a near-cancelling
    sum moves by a visible fraction of a step on float32 noise alone."""
    cfg = small_cfg(perturb=False)
    pair = Pair(cfg)
    pkt0 = pair.packet(0, need_full=True)
    pkt1 = pair.packet(1, need_full=False)
    m = cfg["mapping"]
    w_max = int(m["mapping_window_size"]) + 2
    scratch = CAPACITY - 1
    n_img = 5
    key_map, key_track = jax.random.split(jax.random.PRNGKey(3))
    iters, lr_factor = int(m["iters_first"]), float(m["lr_first_factor"])

    # -- JAX: the fused frame mapper, then the tracking core.
    jstore = jkf.KeyframeStore(CAPACITY, pair.jcam)
    jsel = jkf.make_window_selector(
        pair.jcam, CAPACITY, int(m["mapping_window_size"]), w_max, scratch)
    jmap = jmapper.make_frame_mapper(cfg, pair.jscene, pair.jcam, jsel,
                                     w_max, scratch, importance=False)
    opt_buf = jmap.jit_init({"map": pair.jms,
                             "poses": jnp.zeros((w_max, 7), jnp.float32)})
    jest = jnp.zeros((n_img, 4, 4), jnp.float32).at[0].set(pkt0.gt_c2w)
    (jms, _, jest, jkf_est, jkf_gt, _, jkf_depths, jlosses) = jmap(
        pair.jms, opt_buf, jest, jstore.est_c2w, jstore.gt_c2w,
        jstore.colors, jstore.depths, jnp.asarray(pkt0.color_u8),
        jnp.asarray(pkt0.depth_u16), pkt0.depth_inv_q,
        jnp.asarray(pkt0.gt_c2w), 0, 0, key_map, iters=iters,
        lr_factor=lr_factor, joint_opt=False, admit=True)
    jcore = jax.jit(jtracker.make_track_core(cfg, pair.jscene, pair.jcam))
    jquads = jtracker._pack_tracking_quads(jms, pair.jscene, False)
    jbest, jtrack_losses, jiter_poses = jcore(
        jms, jquads, j_m2p(jest[0][None])[0], pkt1.px_i, pkt1.px_j,
        pkt1.px_color, pkt1.px_depth, key_track)

    # -- The port, on the same packets and the replayed draws.
    store = tkf.KeyframeStore(CAPACITY, pair.cam, "cpu")
    sel = tkf.make_window_selector(
        pair.cam, CAPACITY, int(m["mapping_window_size"]), w_max, scratch)
    map_frame = tmapper.make_frame_mapper(cfg, pair.scene, pair.cam, sel,
                                          w_max, scratch, importance=False)
    est = torch.zeros((n_img, 4, 4))
    est[0] = torch.tensor(pkt0.gt_c2w)
    sel_key = jax.random.fold_in(key_map, 0x7FFFFFFF)
    draws = selector_draws(sel_key, pair.jcam, CAPACITY)
    for it in range(iters):
        draws += map_iteration_draws(key_map, it, int(m["pixels"]),
                                     pair.jcam, pair.jscene, False)
    replay = ReplayDraws(draws)
    losses = map_frame(
        pair.ms, store, est, torch.tensor(pkt0.color_u8),
        torch.tensor(pkt0.depth_u16.astype(np.float32)), pkt0.depth_inv_q,
        torch.tensor(pkt0.gt_c2w), 0, replay, iters=iters,
        lr_factor=lr_factor, joint_opt=False, admit=True)
    assert len(replay) == 0
    store.note_admitted(pkt0.has_depthless, 0)

    np.testing.assert_allclose(N(losses), np.asarray(jlosses), rtol=1e-4)
    assert_map_close(pair.ms, jms, atol=1e-4, sdf_atol=5e-4)
    np.testing.assert_allclose(N(store.est_c2w), np.asarray(jkf_est),
                               atol=1e-6)
    np.testing.assert_allclose(N(store.gt_c2w), np.asarray(jkf_gt),
                               atol=0)
    np.testing.assert_allclose(N(store.depths), np.asarray(jkf_depths),
                               atol=1e-6)
    np.testing.assert_allclose(N(est), np.asarray(jest), atol=1e-6)

    core = ttracker.make_track_core(cfg, pair.scene, pair.cam)
    quads = ttracker.pack_tracking_quads(pair.ms, pair.scene, False)
    best, track_losses, iter_poses = core(
        pair.ms, quads, matrix_to_cam_pose(est[0]),
        torch.tensor(pkt1.px_i.astype(np.int64)),
        torch.tensor(pkt1.px_j.astype(np.int64)),
        torch.tensor(pkt1.px_color), torch.tensor(pkt1.px_depth),
        ReplayDraws([]))
    np.testing.assert_allclose(N(track_losses), np.asarray(jtrack_losses),
                               rtol=1e-4)
    np.testing.assert_allclose(N(iter_poses), np.asarray(jiter_poses),
                               atol=1e-4)
    np.testing.assert_allclose(N(best), np.asarray(jbest), atol=1e-4)
    # The tracked pose moved off its start: the comparison is not vacuous.
    assert np.abs(N(best) - N(matrix_to_cam_pose(est[0]))).max() > 1e-4
