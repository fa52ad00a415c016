"""The port's core, models, ops and utils modules against the JAX package.

Every input is made with numpy from a seed and goes through the JAX
function and its ``myslam_torch`` twin; random draws the JAX function
takes from a key are replayed into the port through ``ReplayDraws``.
Tolerance: float32 atol 1e-5 unless a test states otherwise (both sides
compute in float32 on the CPU; only the order of some sums differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myslam_tpu.core import geometry as jgeo
from myslam_tpu.core import losses as jlosses
from myslam_tpu.core import quaternion as jquat
from myslam_tpu.core import sampling as jsamp
from myslam_tpu.models import decoders as jdec
from myslam_tpu.models import planes as jplanes
from myslam_tpu.ops import composite as jcomp
from myslam_tpu.ops import pixel_gather as jpix
from myslam_tpu.ops.plane_sample import reduced_row_map as j_reduced_row_map
from myslam_torch.core import geometry as tgeo
from myslam_torch.core import losses as tlosses
from myslam_torch.core import quaternion as tquat
from myslam_torch.core import sampling as tsamp
from myslam_torch.core.sampling import ReplayDraws
from myslam_torch.models import decoders as tdec
from myslam_torch.models import planes as tplanes
from myslam_torch.models.convert import from_jax_numpy, to_jax_numpy
from myslam_torch.ops import composite as tcomp
from myslam_torch.ops import pixel_gather as tpix
from myslam_torch.ops.plane_sample import reduced_row_map

torch.set_num_threads(2)  # several test workers share the CPU

ATOL = 1e-5


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(N(port), N(ref), atol=atol, rtol=0)


def rand_poses(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return np.concatenate([q, t], -1)


# -- core/geometry.py, core/quaternion.py --------------------------------------

def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    i = rng.uniform(0, 32, 50).astype(np.float32)
    j = rng.uniform(0, 24, 50).astype(np.float32)
    c2w = np.asarray(jquat.cam_pose_to_matrix(jnp.asarray(rand_poses(rng, 1))))[0]
    intr = (30.0, 31.0, 15.5, 11.5)
    close(tgeo.pixel_dirs(T(i), T(j), *intr), jgeo.pixel_dirs(i, j, *intr))
    ro, rd = tgeo.rays_from_uv(T(i), T(j), T(c2w), *intr)
    jro, jrd = jgeo.rays_from_uv(i, j, c2w, *intr)
    close(ro, jro)
    close(rd, jrd)
    bound = np.array([[-1.0, 2.0], [-1.5, 1.5], [-2.0, 3.0]], np.float32)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    close(tgeo.normalize_3d_coordinate(T(pts), T(bound)),
          jgeo.normalize_3d_coordinate(pts, bound))
    close(tgeo.ray_aabb_exit_t(T(pts * 0.1), rd[:40], T(bound)),
          jgeo.ray_aabb_exit_t(pts * 0.1, np.asarray(jrd)[:40], bound),
          atol=1e-4)
    w2cs = np.asarray(jgeo.invert_pose(jquat.cam_pose_to_matrix(
        jnp.asarray(rand_poses(rng, 3)))))
    close(tgeo.invert_pose(tgeo.invert_pose(T(w2cs))),
          jgeo.invert_pose(jgeo.invert_pose(w2cs)))
    u, v, z = tgeo.project_points(T(pts)[None], T(w2cs)[:, None], *intr)
    ju, jv, jz = jgeo.project_points(pts[None], w2cs[:, None], *intr)
    # Points near the image plane divide by a small z: relative check.
    for a, b in ((u, ju), (v, jv), (z, jz)):
        np.testing.assert_allclose(N(a), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_quaternion_matches_jax():
    rng = np.random.default_rng(1)
    poses = rand_poses(rng, 16)
    poses[:, :4] *= rng.uniform(0.5, 2.0, (16, 1)).astype(np.float32)
    close(tquat.quaternion_to_matrix(T(poses[:, :4])),
          jquat.quaternion_to_matrix(poses[:, :4]))
    c2w = np.asarray(jquat.cam_pose_to_matrix(poses))
    close(tquat.cam_pose_to_matrix(T(poses)), c2w)
    close(tquat.matrix_to_quaternion(T(c2w[:, :3, :3])),
          jquat.matrix_to_quaternion(c2w[:, :3, :3]))
    close(tquat.matrix_to_cam_pose(T(c2w)), jquat.matrix_to_cam_pose(c2w))


# -- core/sampling.py ----------------------------------------------------------

def test_z_vals_match_jax_with_replayed_draws():
    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(3)
    depth = rng.uniform(0.5, 3.0, 30).astype(np.float32)
    for perturb in (False, True):
        ref = jsamp.depth_guided_z_vals(key, depth, 0.06, 32, 8, perturb)
        draws = [jax.random.uniform(key, (30, 40))] if perturb else []
        got = tsamp.depth_guided_z_vals(ReplayDraws(draws), T(depth), 0.06,
                                        32, 8, perturb)
        close(got, ref)
        far = depth + 0.5
        ref = jsamp.uniform_z_vals(key, far, 32, perturb, near=0.1)
        draws = [jax.random.uniform(key, (30, 32))] if perturb else []
        close(tsamp.uniform_z_vals(ReplayDraws(draws), T(far), 32, perturb,
                                   near=0.1), ref)
    z = np.sort(rng.uniform(0, 2, (5, 9)).astype(np.float32), -1)
    close(tsamp.perturb_z_vals(
        ReplayDraws([jax.random.uniform(key, z.shape)]), T(z)),
        jsamp.perturb_z_vals(key, z))


def test_sample_pdf_keeps_unnormalized_quirk():
    rng = np.random.default_rng(4)
    key = jax.random.PRNGKey(5)
    bins = np.sort(rng.uniform(0, 3, (20, 17)).astype(np.float32), -1)
    # Weights that sum well below and above 1, and a zero row.
    weights = rng.uniform(0, 0.2, (20, 16)).astype(np.float32)
    weights[3] *= 20.0
    weights[7] = 0.0
    ref = jsamp.sample_pdf(key, bins, weights, 8)
    u = jax.random.uniform(key, (20, 8))
    close(tsamp.sample_pdf(ReplayDraws([u]), T(bins), T(weights), 8), ref,
          atol=1e-5)
    close(tsamp.sample_pdf(None, T(bins), T(weights), 8, det=True),
          jsamp.sample_pdf(key, bins, weights, 8, det=True))


def test_sample_pixels_replays_jax_draws():
    key = jax.random.PRNGKey(6)
    ri, rj = jsamp.sample_pixels(key, 50, 2, 22, 3, 29)
    kj, ki = jax.random.split(key)
    draws = ReplayDraws([jax.random.randint(kj, (50,), 2, 22),
                         jax.random.randint(ki, (50,), 3, 29)])
    i, j = tsamp.sample_pixels(draws, 50, 2, 22, 3, 29)
    close(i, ri, atol=0)
    close(j, rj, atol=0)
    assert len(draws) == 0
    img = np.random.default_rng(7).normal(size=(24, 32, 3)).astype(np.float32)
    close(tsamp.gather_pixels(T(img), i, j),
          jsamp.gather_pixels(img, ri, rj), atol=0)


def test_replay_rejects_out_of_step_draws():
    with pytest.raises(ValueError):
        ReplayDraws([np.zeros((3,))]).uniform((4,))
    with pytest.raises(ValueError):
        ReplayDraws([np.array([5])]).randint((1,), 0, 5)
    with pytest.raises(RuntimeError):
        ReplayDraws([]).uniform((1,))


# -- core/losses.py ------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(8)
    R, S = 24, 40
    depth = rng.uniform(0.5, 3.0, R).astype(np.float32)
    depth[:3] = 0.0
    z = np.sort(rng.uniform(0.0, 3.5, (R, S)).astype(np.float32), -1)
    sdf = rng.uniform(-1, 1, (R, S)).astype(np.float32)
    mask = rng.uniform(size=R) > 0.3
    args = (0.06, 5.0, 200.0, 10.0)
    close(tlosses.sdf_losses(T(sdf), T(z), T(depth), T(mask), *args),
          jlosses.sdf_losses(sdf, z, depth, mask, *args), atol=1e-4)
    col = rng.uniform(size=(R, 3)).astype(np.float32)
    gt = rng.uniform(size=(R, 3)).astype(np.float32)
    close(tlosses.color_loss(T(gt), T(col), T(mask)),
          jlosses.color_loss(gt, col, mask))
    close(tlosses.depth_loss(T(depth), T(z[:, 5]), T(mask)),
          jlosses.depth_loss(depth, z[:, 5], mask))
    close(tlosses.masked_mean(T(sdf), T(np.zeros_like(sdf, bool))), 0.0)


@pytest.mark.parametrize("n_true", [0, 1, 2, 7, 8])
def test_masked_median_lower_middle_and_empty(n_true):
    rng = np.random.default_rng(n_true)
    x = rng.normal(size=12).astype(np.float32)
    mask = np.zeros(12, bool)
    mask[rng.permutation(12)[:n_true]] = True
    ref = np.asarray(jlosses.masked_median(x, mask))
    got = N(tlosses.masked_median(T(x), T(mask)))
    if n_true == 0:
        assert np.isinf(got) and got > 0 and np.isinf(ref)
    else:
        assert got == ref == np.sort(x[mask])[(n_true - 1) // 2]


# -- ops/composite.py, ops/pixel_gather.py -------------------------------------

def test_composite_matches_jax():
    rng = np.random.default_rng(9)
    R, S = 16, 40
    sdf = rng.uniform(-1, 1, (R, S)).astype(np.float32)
    z = np.sort(rng.uniform(0, 3, (R, S)).astype(np.float32), -1)
    rgb = rng.uniform(size=(R, S, 3)).astype(np.float32)
    pts = rng.normal(size=(R, S, 3)).astype(np.float32)
    alpha = tcomp.sdf2alpha(T(sdf), 10.0)
    jalpha = jcomp.sdf2alpha(sdf, 10.0)
    close(alpha, jalpha)
    close(tcomp.composite_weights(alpha), jcomp.composite_weights(jalpha))
    for a, b in zip(tcomp.composite(alpha, T(z), T(rgb)),
                    jcomp.composite(jalpha, z, rgb)):
        close(a, b)
    m = rng.normal(size=(3, 3)).astype(np.float32)
    d, c = tcomp.composite_topk(alpha, T(z), T(pts),
                                lambda p: torch.sigmoid(p @ T(m)), 12)
    jd, jc = jcomp.composite_topk(jalpha, z, pts,
                                  lambda p: jax.nn.sigmoid(p @ m), 12)
    close(d, jd)
    close(c, jc)


def test_pixel_gather_matches_jax():
    rng = np.random.default_rng(10)
    depths = rng.uniform(size=(3, 6, 8)).astype(np.float32)
    colors = rng.uniform(size=(3, 6, 8, 3)).astype(np.float16)
    flat = rng.integers(0, 3 * 48, 30)
    close(tpix.gather_scalar(T(depths), T(flat)),
          jpix.gather_scalar(jnp.asarray(depths), jnp.asarray(flat)), atol=0)
    close(tpix.gather_rgb(T(colors), T(flat)).float(),
          np.asarray(jpix.gather_rgb(jnp.asarray(colors), jnp.asarray(flat)),
                     np.float32), atol=0)


# -- models/ -------------------------------------------------------------------

BOUND = np.array([[-1.9, 7.94], [-2.2, 4.52], [-2.5, 2.54]], np.float32)


def test_layout_and_bound_match_jax():
    from myslam_tpu.engine.scheduler import compute_bound as j_compute_bound
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    cfg = load_config("configs/Synthetic/room.yaml", DEFAULT_CONFIG)
    np.testing.assert_array_equal(tplanes.compute_bound(cfg),
                                  j_compute_bound(cfg))
    for res in ([0.24, 0.06], [0.48, 0.24], [0.24, 0.03]):
        a = tplanes.make_layout(BOUND, res, 8)
        b = jplanes.make_layout(jnp.asarray(BOUND), res, 8)
        assert (a.shapes, a.offsets, a.total_rows, a.c_dim) == (
            b.shapes, b.offsets, b.total_rows, b.c_dim)
        np.testing.assert_array_equal(reduced_row_map(a),
                                      j_reduced_row_map(b))


def _jax_decoder(seed=0, c_dim=8):
    dec = jdec.init_decoder_params(jax.random.PRNGKey(seed), c_dim=c_dim)
    return jax.tree_util.tree_map(np.asarray, dec)


def test_decoders_match_jax():
    dec = _jax_decoder()
    port = from_jax_numpy({"sdf_atlas": np.zeros((1, 8), np.float32),
                           "color_atlas": np.zeros((1, 8), np.float32),
                           "decoder": dec}).decoder
    rng = np.random.default_rng(11)
    feat = rng.normal(size=(50, 16)).astype(np.float32)
    close(tdec.decode_sdf(port, T(feat)), jdec.decode_sdf(dec, feat))
    close(tdec.decode_rgb(port, T(feat)), jdec.decode_rgb(dec, feat))
    layout = tplanes.make_layout(BOUND, [0.48, 0.24], 8)
    rm = reduced_row_map(layout)
    corners = rng.normal(size=(50, 2 * 32)).astype(np.float32)
    close(tdec.decode_sdf_corners(port, T(corners), T(rm)),
          jdec.decode_sdf_corners(dec, corners, rm))
    close(tdec.decode_rgb_corners(port, T(corners), T(rm)),
          jdec.decode_rgb_corners(dec, corners, rm))
    # The fold equals decoding the reduced features.
    red = corners.reshape(50, 2, 4, 8).sum(2).reshape(50, 16)
    close(tdec.decode_sdf_corners(port, T(corners), T(rm)),
          tdec.decode_sdf(port, T(red)), atol=1e-5)


def test_from_jax_numpy_round_trip():
    layout = jplanes.make_layout(jnp.asarray(BOUND), [0.48, 0.24], 8)
    ms = jplanes.init_map_state(jax.random.PRNGKey(1), layout, layout,
                                jdec.init_decoder_params(
                                    jax.random.PRNGKey(2), c_dim=8))
    tree = jax.tree_util.tree_map(np.asarray, ms)
    port = from_jax_numpy(tree)
    assert port.sdf_atlas.requires_grad and port.color_atlas.requires_grad
    back = to_jax_numpy(port)
    flat_a = jax.tree_util.tree_leaves(
        {"sdf_atlas": tree.sdf_atlas, "color_atlas": tree.color_atlas,
         "decoder": tree.decoder})
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_get_model_and_init_are_seeded():
    from myslam_torch.models.config import get_model

    cfg = {"model": {"c_dim": 8}}
    a = get_model(cfg, torch.Generator().manual_seed(3))
    b = get_model(cfg, torch.Generator().manual_seed(3))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    for lin in a.linears():  # nn.Linear's bound, U(-1/sqrt(in), 1/sqrt(in))
        assert lin.weight.abs().max() <= 1.0 / np.sqrt(lin.in_features)
    assert float(a.beta.detach()) == 10.0


# -- utils/ and tools/ ---------------------------------------------------------

def _small_cfg():
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    cfg = load_config("configs/Synthetic/room_smoke.yaml", DEFAULT_CONFIG)
    cfg["cam"].update(H=24, W=32, fx=20.0, fy=20.0, cx=15.5, cy=11.5)
    return cfg


@pytest.mark.parametrize("cam", [
    {"H": 680, "W": 1200, "fx": 600.0, "fy": 600.0, "cx": 599.5,
     "cy": 339.5, "crop_edge": 0},
    {"H": 480, "W": 640, "fx": 517.3, "fy": 516.5, "cx": 318.6,
     "cy": 255.3, "crop_size": [384, 512], "crop_edge": 8}])
def test_camera_matches_jax(cam):
    from myslam_tpu.engine.camera import Camera as JCamera
    from myslam_torch.engine.camera import Camera

    assert Camera.from_cfg({"cam": cam}).__dict__ == \
        JCamera.from_cfg({"cam": cam}).__dict__


def test_tum_cell_camera_and_schedule_match_their_source():
    """slambench's ``tum`` configuration holds freiburg1_desk.yaml's
    camera after its resize and crop, and every other key as the source
    chain (myslam.yaml, tum.yaml, freiburg1_desk.yaml) gives it, but the
    keys its ``set`` names."""
    import json

    from myslam_torch.engine.camera import Camera
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    src = load_config("configs/TUM_RGBD/freiburg1_desk.yaml",
                      DEFAULT_CONFIG)
    with open("slambench/configs/tum.json") as f:
        tum = json.load(f)
    cam, want = tum["config"]["cam"], Camera.from_cfg(src)
    assert (cam["H"], cam["W"]) == (want.H, want.W) == (368, 496)
    for k in ("fx", "fy", "cx", "cy"):
        assert abs(cam[k] - getattr(want, k)) < 1e-9, k
    assert Camera.from_cfg(tum["config"]) == Camera(
        H=368, W=496, fx=cam["fx"], fy=cam["fy"], cx=cam["cx"],
        cy=cam["cy"])

    def flat(d, pre=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, pre + k + "."))
            else:
                out[pre + k] = v
        return out

    def kept(key):
        return not any(key == s or key.startswith(s + ".")
                       for s in list(tum["set"]) + ["inherit_from", "data"])

    got, ref = flat(tum["config"]), flat(src)
    assert {k for k in ref if kept(k)} == {k for k in got if kept(k)}
    for k in ref:
        if kept(k):
            assert got[k] == ref[k], k
    for k in ("tracking.iters", "tracking.pixels", "mapping.iters",
              "mapping.pixels", "mapping.every_frame",
              "mapping.keyframe_every", "rendering.n_stratified",
              "rendering.learnable_beta", "mapping.bound"):
        assert kept(k), k


def test_config_matches_jax():
    from myslam_tpu.utils.config import DEFAULT_CONFIG as JDEFAULT
    from myslam_tpu.utils.config import load_config as jload
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    assert load_config("configs/Synthetic/room_smoke.yaml",
                       DEFAULT_CONFIG) == jload(
        "configs/Synthetic/room_smoke.yaml", JDEFAULT)


@pytest.mark.parametrize("need_full", [True, False])
def test_build_packet_matches_jax(need_full):
    from myslam_tpu.utils import datasets as jdata
    from myslam_torch.utils import datasets as tdata

    cfg = _small_cfg()
    jds, tds = jdata.get_dataset(cfg), tdata.get_dataset(cfg)
    assert len(jds) == len(tds)
    kw = dict(iters=3, n_px=20, ie_h=2, ie_w=2, need_full=need_full, seed=4)
    a = jdata.build_packet(jds, 5, **kw)
    b = tdata.build_packet(tds, 5, **kw)
    for name in ("gt_c2w", "px_i", "px_j", "px_color", "color_u8",
                 "depth_u16"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), y, err_msg=name)
    np.testing.assert_allclose(b.px_depth, a.px_depth, atol=1e-6)
    assert b.depth_inv_q == pytest.approx(a.depth_inv_q, rel=1e-6)
    assert b.has_depthless == a.has_depthless


def test_eval_ate_matches_jax():
    from myslam_tpu.tools.eval_ate import evaluate_run as j_eval
    from myslam_torch.tools.eval_ate import evaluate_run

    rng = np.random.default_rng(12)
    gt = np.array(jquat.cam_pose_to_matrix(jnp.asarray(rand_poses(rng, 10))))
    est = gt.copy()
    est[:, :3, 3] += rng.normal(scale=0.01, size=(10, 3)).astype(np.float32)
    gt[4, 0, 0] = np.nan
    a, b = evaluate_run(est, gt, 2.0), j_eval(est, gt, 2.0)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-9, abs=1e-12)
