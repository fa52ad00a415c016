"""The port's visualizer against the JAX package's: full-image rays, the
full-frame image renderer, the panels and their gating, and the in-loop
tracking and mapping panels.

The image renderer replays the draws JAX makes from its chunk keys
(``myslam_tpu/render/renderer.py:make_image_renderer``: one key per
chunk, then ``build_z_vals_core``'s split).  The loop runs at 24x32 on
the three keyframe stores with ``room_smoke``'s schedule cut to 5
frames: tracking panels every 2nd frame at iterations 0 and 4 of 8,
mapping panels every 4th frame at iterations 0, 5 and 10 of 11.
Tolerances: depth and color of the image renderer 1e-5 absolute (f32,
sums over 40 samples in another order); the plasma table within one
uint8 level of matplotlib's (the port rounds, matplotlib truncates);
trajectories, maps and renders on the CPU bit for bit.
"""

import copy
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from myslam_torch.core.geometry import rays_full_image
from myslam_torch.core.quaternion import cam_pose_to_matrix
from myslam_torch.core.sampling import ReplayDraws, TorchDraws
from myslam_torch.engine.scheduler import VIS_SEED_OFFSET, SLAMSystem
from myslam_torch.render import renderer as trend
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
from myslam_torch.utils.imageio import read_jpeg
from myslam_torch.utils.visualizer import PLASMA_U8, FrameVisualizer, \
    compose_panel, plasma, to_u8
from myslam_tpu.core.geometry import rays_full_image as j_rays_full_image
from myslam_tpu.render import renderer as jrend
from test_torch_slice import N, Pair, render_draws, small_cfg

torch.set_num_threads(2)  # several test workers share the CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORES = ("tpu", "cpu", "host_staged")  # float, packed, host-staged


def test_rays_full_image_matches_jax():
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[0.0, -1.0, 0.0], [0.6, 0.0, -0.8],
                            [0.8, 0.0, 0.6]], np.float32)
    c2w[:3, 3] = [1.0, 2.0, 0.5]
    args = (24, 32, 20.0, 21.0, 15.5, 11.5)
    ro, rd = rays_full_image(*args, torch.tensor(c2w))
    jro, jrd = j_rays_full_image(*args, jnp.asarray(c2w))
    assert ro.shape == rd.shape == (24, 32, 3)
    np.testing.assert_allclose(N(ro), np.asarray(jro), atol=1e-6, rtol=0)
    np.testing.assert_allclose(N(rd), np.asarray(jrd), atol=1e-6, rtol=0)


def test_image_renderer_matches_jax():
    """24x32 in chunks of 200 rays: 4 chunks, 32 pad rays; a third of the
    pixels without depth take the coarse pass; jittered samples."""
    pair = Pair(small_cfg(perturb=True))
    cam = pair.cam
    c2w = np.asarray(pair.dataset.poses[2], np.float32)
    _, depth, _ = pair.dataset.get_frame(2)
    depth = np.asarray(depth, np.float32).copy()
    depth[::3] = 0.0
    key = jax.random.PRNGKey(11)
    jrender = jrend.make_image_renderer(pair.jscene, pair.jcam,
                                        ray_batch_size=200)
    jd, jc = jrender(pair.jms, jnp.asarray(c2w), jnp.asarray(depth), key)
    draws = []
    for k in jax.random.split(key, 4):
        draws += render_draws(k, 200, pair.jscene, importance=True)
    replay = ReplayDraws(draws)
    render = trend.make_image_renderer(pair.scene, cam, ray_batch_size=200)
    d, c = render(pair.ms, torch.tensor(c2w), torch.tensor(depth), replay)
    assert len(replay) == 0
    assert d.shape == (24, 32) and c.shape == (24, 32, 3)
    np.testing.assert_allclose(N(d), np.asarray(jd), atol=1e-5, rtol=0)
    np.testing.assert_allclose(N(c), np.asarray(jc), atol=1e-5, rtol=0)


def test_plasma_table_matches_matplotlib():
    from matplotlib import colormaps

    ref = colormaps["plasma"](np.arange(256), bytes=True)[:, :3]
    assert PLASMA_U8.shape == (256, 3)
    assert np.abs(PLASMA_U8.astype(int) - ref.astype(int)).max() <= 1
    # Values map to entries as matplotlib's Normalize + Colormap do,
    # clamped at both ends.
    x = np.linspace(-1.0, 6.0, 2001, dtype=np.float32)
    mpl = colormaps["plasma"](np.clip(x / 5.0, 0.0, 1.0), bytes=True)
    assert np.abs(plasma(x, 5.0).astype(int)
                  - mpl[:, :3].astype(int)).max() <= 1


def test_panel_layout_and_masked_residuals():
    """Tiles in order (input, rendered, |residual|) for depth over color;
    residuals 0 where the input depth is 0; depth tiles on [0, the
    largest input depth]."""
    rng = np.random.default_rng(0)
    H, W = 6, 8
    gt_d = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    gt_d[0, :] = 0.0
    d = gt_d + rng.normal(0, 0.3, (H, W)).astype(np.float32)
    gt_c = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    c = rng.uniform(-0.2, 1.2, (H, W, 3)).astype(np.float32)
    panel = compose_panel(gt_d, gt_c, d, c)
    assert panel.shape == (2 * H, 3 * W, 3) and panel.dtype == np.uint8
    vmax = float(gt_d.max())
    d_res = np.abs(gt_d - d)
    d_res[0] = 0.0
    c_res = np.abs(gt_c - c)
    c_res[0] = 0.0
    tiles = [plasma(gt_d, vmax), plasma(d, vmax), plasma(d_res, vmax),
             to_u8(gt_c), to_u8(c), to_u8(c_res)]
    for k, tile in enumerate(tiles):
        r, q = divmod(k, 3)
        np.testing.assert_array_equal(
            panel[r * H:(r + 1) * H, q * W:(q + 1) * W], tile)
    # The masked row: residual tiles show plasma(0) and black.
    assert (panel[0, 2 * W:3 * W] == PLASMA_U8[0]).all()
    assert (panel[H, 2 * W:3 * W] == 0).all()
    assert not (panel[1:H, 2 * W:3 * W] == PLASMA_U8[0]).all()


def test_visualizer_gating_and_file(tmp_path):
    pair = Pair(small_cfg(perturb=False))
    vis = FrameVisualizer(3, 0, str(tmp_path / "v"), pair.scene, pair.cam,
                          TorchDraws(0, "cpu"))
    assert vis.freq == 3 and vis.inside_freq == 1  # max(..., 1)
    vis = FrameVisualizer(3, 4, str(tmp_path / "v"), pair.scene, pair.cam,
                          TorchDraws(0, "cpu"))
    _, depth, _ = pair.dataset.get_frame(3)
    depth = np.asarray(depth, np.float32)
    color = np.full((24, 32, 3), 0.5, np.float32)
    c2w = torch.tensor(np.asarray(pair.dataset.poses[3], np.float32))
    for idx, it in ((1, 0), (3, 2), (4, 4)):
        assert vis.save_imgs(idx, it, depth, color, c2w, pair.ms) is None
    path = vis.save_imgs(3, 4, depth, color, c2w, pair.ms)
    assert path == str(tmp_path / "v" / "00003_0004.jpg")
    assert read_jpeg(path).shape == (48, 96, 3)
    assert [r["iter"] for r in vis.records] == [4]


# -- the loop --------------------------------------------------------------------

def vis_config(tmp_path, store: str, vis: bool, **mapping) -> dict:
    cfg = {
        "inherit_from": os.path.join(REPO, "configs", "Synthetic",
                                     "room_smoke.yaml"),
        "keyframe_device": store,
        "data": {"n_frames": 5, "output": str(tmp_path / "out")},
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5},
        "model": {"c_dim": 8},
        "planes_res": {"coarse": 0.48, "fine": 0.24},
        "c_planes_res": {"coarse": 0.48, "fine": 0.12},
        "tracking": {"pixels": 64, "iters": 8, "ignore_edge_H": 2,
                     "ignore_edge_W": 2},
        "mapping": {"pixels": 64, "iters_first": 10, "iters": 11,
                    "mapping_window_size": 3, **mapping},
        "meshing": {"resolution": 0.25},
    }
    if vis:
        cfg["tracking"].update(vis_freq=2, vis_inside_freq=4)
        cfg["mapping"].update(vis_freq=4, vis_inside_freq=5)
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "vis.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return load_config(str(path), DEFAULT_CONFIG)


def jax_panel_names(cfg: dict) -> list[str]:
    """The files the JAX package's gating writes for this schedule:
    ``_maybe_track_vis`` (myslam_tpu/engine/scheduler.py:972-996) at
    iterations range(0, iters, inside_freq) of tracked frames with
    idx % tracking.vis_freq == 0; ``_make_map_vis_hook`` (:681-716) at
    iteration 0 and the multiples of inside_freq below the iteration
    count of mapped frames with idx % mapping.vis_freq == 0, frame 0 not
    under no_vis_on_first_frame (chunk_iters = inside_freq)."""
    t, m = cfg["tracking"], cfg["mapping"]
    n = cfg["data"]["n_frames"]
    names = []
    for idx in range(n):
        if idx > 0 and idx % max(t["vis_freq"], 1) == 0:
            names += [f"tracking_vis/{idx:05d}_{it:04d}.jpg" for it in
                      range(0, t["iters"], max(t["vis_inside_freq"], 1))]
        mapped = idx % m["every_frame"] == 0 or idx == n - 1
        if (mapped and idx % max(m["vis_freq"], 1) == 0
                and not (idx == 0 and m["no_vis_on_first_frame"])):
            f = max(m["vis_inside_freq"], 1)
            iters = m["iters_first"] if idx == 0 else m["iters"]
            names += [f"mapping_vis/{idx:05d}_{it:04d}.jpg"
                      for it in [0, *range(f, iters, f)]]
    return sorted(names)


def run_loop(cfg, capture=False):
    """The loop on the CPU; with ``capture``, every panel render's
    generator state, pose, inputs and outputs, and the tracking map and
    per-iteration poses of each group."""
    slam = SLAMSystem(cfg, seed=0, device="cpu")
    renders, groups = [], []
    if capture:
        for vis in (slam.track_vis, slam.map_vis):
            def wrapped(ms, c2w, gt_depth, draws, _render=vis._render_img):
                state = draws.generator.get_state()
                out = _render(ms, c2w, gt_depth, draws)
                renders.append((state, c2w.clone(), gt_depth.clone(), out))
                return out
            vis._render_img = wrapped
        group = slam.group_tracker

        def tracked(ms, *a):
            snapshot = copy.deepcopy(ms)
            out = group(ms, *a)
            groups.append((snapshot, out[3].clone()))
            return out
        slam.group_tracker = tracked
    slam.run_loop()
    return slam, renders, groups


def panel_files(slam) -> list[str]:
    return sorted(os.path.relpath(p, slam.output) for p in glob.glob(
        os.path.join(slam.output, "*_vis", "*.jpg")))


@pytest.mark.parametrize("store", STORES)
def test_panels_follow_jax_gating_and_leave_the_trajectory_alone(
        tmp_path, store):
    on, _, _ = run_loop(vis_config(tmp_path / "on", store, True))
    off, _, _ = run_loop(vis_config(tmp_path / "off", store, False))
    assert torch.equal(on.est, off.est)
    assert torch.equal(on.map_state.sdf_atlas, off.map_state.sdf_atlas)
    assert panel_files(off) == []
    want = jax_panel_names(on.cfg)
    assert want == sorted([f"tracking_vis/{i:05d}_{k:04d}.jpg"
                           for i in (2, 4) for k in (0, 4)] + [
        f"mapping_vis/00004_{k:04d}.jpg" for k in (0, 5, 10)])
    assert panel_files(on) == want
    for r in on.track_vis.records + on.map_vis.records:
        assert read_jpeg(r["file"]).shape == (48, 96, 3)


def test_first_frame_panels_without_no_vis_on_first_frame(tmp_path):
    cfg = vis_config(tmp_path, "tpu", True, no_vis_on_first_frame=False)
    slam, _, _ = run_loop(cfg)
    names = panel_files(slam)
    assert names == jax_panel_names(cfg)
    assert [n for n in names if n.startswith("mapping_vis/00000")] == [
        f"mapping_vis/00000_{k:04d}.jpg" for k in (0, 5)]


def test_panels_render_the_maps_and_poses_they_name(tmp_path):
    """Mapping panel m of frame 4 renders the map of a run stopped after
    m of frame 4's iterations; tracking panel k renders the frozen map at
    iter_poses[k]; each bit for bit, with the panel's draws."""
    cfg = vis_config(tmp_path / "vis", "tpu", True)
    slam, renders, groups = run_loop(cfg, capture=True)
    records = slam.track_vis.records + slam.map_vis.records
    # Renders happen in the loop's order: the group's tracking panels,
    # then frame 4's mapping panels.
    order = sorted(range(len(records)), key=lambda k: (
        records[k]["file"].split(os.sep)[-2] != "tracking_vis", k))
    assert len(renders) == len(records) == 7
    render = trend.make_image_renderer(slam.scene, slam.cam)

    def again(ms, state, c2w, gt_depth):
        draws = TorchDraws(0, "cpu")
        draws.generator.set_state(state)
        return render(ms, c2w, gt_depth, draws)

    (track_map, iter_poses), = groups
    tracked = [records[k] for k in order[:4]]
    for rec, (state, c2w, gt_depth, out) in zip(tracked, renders[:4]):
        g = rec["frame"] - 1
        assert torch.equal(c2w, cam_pose_to_matrix(iter_poses[g])[
            rec["iter"]])
        for a, b in zip(again(track_map, state, c2w, gt_depth), out):
            assert torch.equal(a, b)
    # The panels' draws: seeded apart from the loop's.
    first_state = TorchDraws(VIS_SEED_OFFSET, "cpu").generator.get_state()
    assert torch.equal(renders[0][0], first_state)
    mapped = [records[k] for k in order[4:]]
    assert [r["iter"] for r in mapped] == [0, 5, 10]
    for rec, (state, c2w, gt_depth, out) in zip(mapped, renders[4:]):
        m = rec["iter"]
        if m == 0:
            ms = track_map  # the map before frame 4's mapping
        else:
            stopped, _, _ = run_loop(vis_config(
                tmp_path / f"stop{m}", "tpu", False, iters=m))
            ms = stopped.map_state
            np.testing.assert_allclose(N(c2w), N(stopped.est[4]), atol=1e-6)
        for a, b in zip(again(ms, state, c2w, gt_depth), out):
            assert torch.equal(a, b)
