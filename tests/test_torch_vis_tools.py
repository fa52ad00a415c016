"""The port's replay frontend, ``visualizer_torch.py`` and the profiling
tools, against the JAX package's where it has a counterpart.

  * ``SLAMFrontend`` (``utils/frontend.py``): the mock backend records the
    caller's events; the backend resolver takes the headless recorder
    without a display; the headless loop writes top views from the same
    events, in process and in its spawned child;
  * ``visualizer_torch.replay`` on ``tests/test_tools.py``'s fixture (20
    poses, culled meshes at frames 5 and 15, every 5th frame): 4 frames,
    the mesh swapping at 5 and 15, and each background depth equal to
    the JAX package's rasterizer on the same mesh and camera (1e-5
    relative on the covered pixels, the same coverage:
    tests/test_torch_mesh_eval.py's tolerance);
  * ``profile_components``, ``microbench``, ``bench_raysweep`` and
    ``bench_map_bf16`` at 24x32 on the CPU with ``--json``: their keys;
    ``bench_raysweep.fit_and_rows`` equal to the JAX tool's.
"""

import os
import queue
import sys

import numpy as np
import pytest
import torch
import yaml

from myslam_torch.utils import frontend
from myslam_torch.utils.imageio import read_jpeg
from myslam_torch.utils.ply import write_ply

torch.set_num_threads(2)  # several test workers share the CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import visualizer_torch  # noqa: E402


def test_frontend_mock_and_headless(tmp_path, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    assert frontend.pick_backend("auto") == "headless"
    assert frontend.pick_backend("mock") == "mock"

    fe = frontend.SLAMFrontend(str(tmp_path), backend="mock").start()
    pose = np.eye(4)
    fe.update_pose(0, pose, pose)
    fe.update_mesh("m.ply")
    fe.update_pose(10, pose, pose)
    fe.join()
    assert [e[0] for e in fe._mock_events] == ["pose", "mesh", "pose",
                                                "close"]

    # The headless loop in process: 12 poses -> the 1st and 11th received
    # and, at close, the last.
    q = queue.Queue()
    for i in range(12):
        p = np.eye(4)
        p[:3, 3] = [0.1 * i, 0.05 * i * i, 0.0]
        g = p.copy()
        g[1, 3] += 0.3
        q.put(("pose", i, p, g))
    q.put(("close",))
    frontend._headless_loop(q, str(tmp_path))
    names = sorted(os.listdir(tmp_path / "vis"))
    assert names == ["live_00000.jpg", "live_00010.jpg", "live_00011.jpg"]
    img = read_jpeg(str(tmp_path / "vis" / "live_00011.jpg"))
    assert img.shape == (frontend.LIVE_HW, frontend.LIVE_HW, 3)
    # Red and green trajectories are drawn.
    assert ((img[..., 0] > 200) & (img[..., 1] < 80)).sum() > 20
    assert ((img[..., 1] > 100) & (img[..., 0] < 80)).sum() > 20


def test_frontend_child_process_records_and_exits(tmp_path):
    fe = frontend.SLAMFrontend(str(tmp_path), backend="headless").start()
    for i in range(3):
        fe.update_pose(i, np.eye(4), np.eye(4))
    fe.join()
    assert not fe._proc.is_alive() and fe._proc.exitcode == 0
    assert sorted(os.listdir(tmp_path / "vis")) == ["live_00000.jpg",
                                                    "live_00002.jpg"]


def replay_fixture(tmp_path):
    """tests/test_tools.py::test_replay_swaps_meshes's run."""
    out = tmp_path / "run"
    (out / "ckpts").mkdir(parents=True)
    (out / "mesh").mkdir()
    n = 20
    est = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    est[:, 0, 3] = np.linspace(0, 1, n)
    np.savez(out / "ckpts" / "00019.npz", idx=n - 1,
             estimate_c2w_list=est, gt_c2w_list=est)
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    f = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)
    write_ply(str(out / "mesh" / "00005_mesh_culled.ply"), v, f)
    write_ply(str(out / "mesh" / "00015_mesh_culled.ply"), v + 0.5, f)
    return out, est


@pytest.mark.parametrize("top_view", [False, True])
def test_replay_swaps_meshes_and_matches_jax_background(tmp_path, top_view):
    from myslam_tpu.utils import meshmath as jmm
    from myslam_tpu.utils.ply import read_ply as j_read_ply

    out, est = replay_fixture(tmp_path)
    frames = visualizer_torch.replay(str(out), top_view=top_view,
                                     every=5, device="cpu")
    assert [os.path.basename(p) for p in frames] == [
        "00000.jpg", "00005.jpg", "00010.jpg", "00015.jpg"]
    for p in frames:
        assert read_jpeg(p).shape == (visualizer_torch.H, visualizer_torch.W,
                                      3)
    sched = visualizer_torch._mesh_schedule(str(out), len(est))
    shown = [visualizer_torch.mesh_at(sched, i) for i in (0, 5, 10, 15)]
    assert [None if s is None else os.path.basename(s) for s in shown] == [
        None, "00005_mesh_culled.ply", "00005_mesh_culled.ply",
        "00015_mesh_culled.ply"]
    # The fixed camera frames the last mesh; the background of each mesh
    # equals the JAX package's rasterizer's.
    verts, _, _ = j_read_ply(sched[-1][1])
    w2c = visualizer_torch.mesh_view(verts, top_view)
    from myslam_torch.utils.meshmath import make_depth_rasterizer

    H, W, F = visualizer_torch.H, visualizer_torch.W, visualizer_torch.FOCAL
    ours = make_depth_rasterizer(H, W, F, F, W / 2, H / 2, device="cpu")
    theirs = jmm.make_depth_rasterizer(H, W, F, F, W / 2, H / 2)
    for _, path in sched:
        got = visualizer_torch.mesh_depth(path, w2c, ours)
        v, f, _ = j_read_ply(path)
        v, f = jmm.subdivide_to_edge(v, f, visualizer_torch.EDGE)
        ref = np.asarray(theirs(v[f], w2c))
        cover = ref > 0
        assert cover.mean() > 0.01
        np.testing.assert_array_equal(got > 0, cover)
        np.testing.assert_allclose(got[cover], ref[cover], rtol=1e-5,
                                   atol=0)
    # The background shows in the frames after the swap: gray pixels.
    img = read_jpeg(frames[1])
    gray = (np.abs(img.astype(int) - img[..., :1].astype(int)).max(-1) < 8) \
        & (img[..., 0] < 240)
    assert gray.sum() > 100


def test_replay_interactive_feeds_the_frontend(tmp_path):
    out, _ = replay_fixture(tmp_path)
    fe = visualizer_torch.replay_interactive(str(out), every=5,
                                             backend="mock")
    assert [e[0] for e in fe._mock_events] == [
        "pose", "mesh", "pose", "pose", "mesh", "pose", "close"]


# -- the tools --------------------------------------------------------------------

def tiny_config(tmp_path) -> str:
    cfg = {
        "inherit_from": os.path.join(REPO, "configs", "Synthetic",
                                     "room.yaml"),
        "data": {"n_frames": 5, "output": str(tmp_path / "out")},
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5},
        "model": {"c_dim": 8},
        "planes_res": {"coarse": 0.48, "fine": 0.24},
        "c_planes_res": {"coarse": 0.48, "fine": 0.12},
        "mapping": {"mapping_window_size": 3, "pixels": 64},
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


COMPONENT_KEYS = {"ms", "device_ms", "launches"}
TOOLS = {
    "profile_components": (["--iters", "2"],
                           {"device", "n_rays", "n_samples", "color_topk",
                            "map_bf16", "components", "backward_ms",
                            "fwd_unaccounted_ms"}),
    "microbench": (["--iters", "2", "--n-rays", "16"],
                   {"device", "points", "sdf_rows", "color_rows", "ms"}),
    "bench_raysweep": (["--iters", "2", "--reps", "1", "--rays",
                        "64,32,16,8,4"],
                       {"device", "window_iters", "reps", "lanes"}),
    "bench_map_bf16": (["--iters", "2", "--rounds", "1"],
                       {"device", "window_iters", "rounds", "lanes"}),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_runs_on_the_cpu(tmp_path, capsys, tool):
    import importlib

    mod = importlib.import_module(f"myslam_torch.tools.{tool}")
    argv, keys = TOOLS[tool]
    rep = mod.main(["--config", tiny_config(tmp_path), "--device", "cpu",
                    "--json", *argv])
    assert keys <= set(rep) and rep["device"] == "cpu"
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].startswith("{")
    if tool == "profile_components":
        assert set(rep["components"]) == {
            "full_grad", "forward", "raygen", "sdf_field", "rgb_field",
            "mlp_only", "composite", "adam", "track_frame"}
        for c in rep["components"].values():
            assert set(c) == COMPONENT_KEYS and c["ms"] > 0
            assert c["device_ms"] is None and c["launches"] is None
        assert rep["track_iter_ms"] == (rep["components"]["track_frame"]
                                        ["ms"] / rep["track_iters"])
    elif tool == "microbench":
        assert len(rep["ms"]) == 10 and all(v > 0 for v in
                                             rep["ms"].values())
    elif tool == "bench_raysweep":
        (lane,) = rep["lanes"].values()
        assert lane["rays"] == [64, 32, 16, 8, 4]
        assert len(lane["iter_ms"]) == 5 and len(lane["dp_compute_rows"]) == 5
    else:
        assert set(rep["lanes"]) == {"topk", "exact"}
        for lane in rep["lanes"].values():
            assert {"f32_ms_per_iter", "bf16_ms_per_iter",
                    "speedup"} <= set(lane)


def test_raysweep_never_writes_the_repository_record(tmp_path):
    from myslam_torch.tools import bench_raysweep

    with pytest.raises(SystemExit, match="TPU record"):
        bench_raysweep.main(["--config", tiny_config(tmp_path), "--device",
                             "cpu", "--out",
                             os.path.join(REPO, "raysweep.json")])


def test_fit_and_rows_matches_jax():
    from myslam_torch.tools.bench_raysweep import fit_and_rows
    from myslam_tpu.tools.bench_raysweep import fit_and_rows as j_fit

    rays = [4000, 2000, 1000, 500, 250]
    for iter_ms in ([15.08, 13.86, 13.64, 16.13, 15.64],
                    [30.0, 17.5, 11.0, 8.2, 7.1],
                    [21.3, 12.0, 7.4, 5.0, 4.1]):
        assert fit_and_rows(rays, iter_ms) == j_fit(rays, iter_ms)
    rays = [4000, 1000, 250]  # shares 2000 and 500 come from the fit
    assert fit_and_rows(rays, [30.0, 11.0, 7.1]) == j_fit(rays,
                                                          [30.0, 11.0, 7.1])
