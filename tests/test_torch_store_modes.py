"""The keyframe store modes in the port's loop, on the CPU.

``keyframe_device`` picks the store as in the JAX package; the three
stores run one tiny sequence (tests/test_torch_mesh.py's 24x32 config,
every frame mapped and admitted, so frame 5 maps with joint poses):

  * ``packed`` and ``host_staged`` make the same draws and read the same
    bytes through the same gather, so their trajectories are equal bit
    for bit; both are within 5e-3 m of the float store, whose colors
    went through float16 (u8/255 read directly differs by ~5e-4
    relative, tests/test_host_keyframes.py);
  * a line cache at its minimum size evicts and re-uploads, and gives
    the trajectory of a cache that never evicts;
  * both stores' checkpoints come back byte for byte, and the
    host-staged store is meshed from its host-side depths.
"""

import json
import os

import numpy as np
import pytest
import torch

from myslam_tpu.engine.camera import Camera as JCamera
from myslam_tpu.engine.keyframes import KeyframeStore as JKeyframeStore
from myslam_torch.engine.scheduler import SLAMSystem
from myslam_torch.utils import mesher, ply
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
from test_torch_mesh import REPO, tiny_config

torch.set_num_threads(2)  # several test workers share the CPU

MODES = ("device", "packed", "host_staged")


def every_frame_config(tmp_path, frames=6, **mapping):
    """tiny_config with every frame mapped and admitted."""
    cfg = tiny_config(tmp_path)
    cfg["data"]["n_frames"] = frames
    cfg["mapping"].update(every_frame=1, keyframe_every=1, **mapping)
    return cfg


def run(cfg, mode, output):
    cfg = {**cfg, "keyframe_device": mode,
           "data": {**cfg["data"], "output": str(output)}}
    slam = SLAMSystem(cfg, seed=0, device="cpu")
    slam.run_loop()
    return slam


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("store_modes")
    cfg = every_frame_config(tmp)
    return {mode: run(cfg, mode, tmp / mode) for mode in MODES}


def test_tum_schedule_builds_the_packed_store(tmp_path):
    """room_tum_schedule.yaml says ``keyframe_device: cpu``: the port
    keeps the packet's u8 color and u16 depth with a scale per slot, half
    the bytes of the float16/float32 store."""
    cfg = load_config(os.path.join(REPO, "configs", "Synthetic",
                                   "room_tum_schedule.yaml"), DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = 3
    cfg["data"]["output"] = str(tmp_path / "out")
    slam = SLAMSystem(cfg, seed=0, device="cpu")
    st = slam.store
    cap = st.capacity
    assert cap == 5 and st.mode == "packed" and st.packed
    assert st.colors.dtype == torch.uint8
    assert st.colors.shape == (cap, 480, 640, 3)
    assert st.depths_u16.dtype == torch.uint16
    assert st.depths_u16.shape == (cap, 480, 640)
    assert st.depth_inv_q.dtype == torch.float32
    assert st.depth_inv_q.shape == (cap,)
    assert not hasattr(st, "depths")
    st.depths_u16[1] = 40000
    st.depth_inv_q[1] = 1e-4
    assert float(st.depths_float()[1, 7, 9]) == np.float32(
        40000 * np.float32(1e-4))
    assert 2 * st.imagery_bytes() == cap * 480 * 640 * (3 * 2 + 4)


@pytest.mark.parametrize("keyframe_device", [
    "tpu", "device", "cpu", "packed", "host", "host_staged"])
def test_keyframe_device_picks_the_store_as_jax_does(tmp_path,
                                                     keyframe_device):
    cfg = tiny_config(tmp_path)
    cfg["keyframe_device"] = keyframe_device
    st = SLAMSystem(cfg, seed=0, device="cpu").store
    # The JAX scheduler's mapping (myslam_tpu/engine/scheduler.py).
    host = keyframe_device in ("host", "host_staged")
    jst = JKeyframeStore(4, JCamera(H=8, W=8, fx=4.0, fy=4.0, cx=3.5,
                                    cy=3.5),
                         device="host_staged" if host else keyframe_device)
    assert (st.packed, st.host_mode) == (jst.packed, jst.host_mode)
    assert hasattr(st, "cache_colors") == host


@pytest.mark.parametrize("lines,want", [(1, 5), (7, 7), (64, 9)])
def test_host_cache_lines_clamp(tmp_path, lines, want):
    """max(w_max + 1, min(lines, capacity + 1)): w_max 4, capacity 8."""
    cfg = every_frame_config(tmp_path, mapping_window_size=2,
                             host_cache_lines=lines)
    cfg["keyframe_device"] = "host_staged"
    slam = SLAMSystem(cfg, seed=0, device="cpu")
    assert (slam.w_max, slam.store.capacity) == (4, 8)
    assert slam.store.cache_lines == want
    assert slam.store.cache_colors.shape == (want, 24, 32, 3)


def test_store_modes_match(runs):
    dev = runs["device"]
    n = dev.store.count
    assert n == 6 and all(r.store.count == n for r in runs.values())
    # Every frame mapped; frame 5 with five keyframes stored, so with
    # joint poses.
    assert [r["map_iters"] for r in dev.frame_log] == [20, 3, 3, 3, 3, 3]
    np.testing.assert_array_equal(runs["packed"].estimates,
                                  runs["host_staged"].estimates)
    np.testing.assert_array_equal(runs["packed"].store.est_c2w[:n].numpy(),
                                  runs["host_staged"].store.est_c2w[:n]
                                  .numpy())
    for mode in ("packed", "host_staged"):
        d = np.linalg.norm(runs[mode].estimates[:, :3, 3]
                           - dev.estimates[:, :3, 3], axis=-1)
        assert d.max() < 5e-3, (mode, d)
        np.testing.assert_allclose(runs[mode].store.est_c2w[:n].numpy(),
                                   dev.store.est_c2w[:n].numpy(), atol=5e-3)
    host = runs["host_staged"]
    # One selection fetch per mapped frame; every keyframe was bound to a
    # line at admission, so nothing was uploaded again.
    assert host.selection_fetches == 6 and host.store.cache_misses == 0
    assert sorted(host.store.line_of_slot[:n]) == list(range(n))


def test_host_cache_eviction_exact(tmp_path):
    """A minimum-size line cache (window and scratch only, evicting and
    re-uploading) gives the trajectory of one that never evicts."""
    cfg = every_frame_config(tmp_path, frames=10, mapping_window_size=2)
    cfg["mapping"]["every_frame"] = 2
    big = run(cfg, "host_staged", tmp_path / "big")
    cfg["mapping"]["host_cache_lines"] = 1
    small = run(cfg, "host_staged", tmp_path / "small")
    assert small.store.cache_lines == small.w_max + 1  # clamped up
    np.testing.assert_array_equal(small.estimates, big.estimates)
    st = small.store
    evicted = [s for s in range(st.count) if st.line_of_slot[s] < 0]
    assert evicted, "expected evictions with a minimum-size cache"
    before = st.cache_misses
    (ln,) = st.stage_lines([evicted[0]])
    assert st.cache_misses == before + 1
    assert torch.equal(st.cache_colors[ln], st.colors_u8[evicted[0]])
    assert torch.equal(st.cache_depths[ln], st.depths_u16[evicted[0]])
    assert float(st.cache_inv_q[ln]) == float(st.depth_inv_q[evicted[0]])


@pytest.mark.parametrize("mode", ["packed", "host_staged"])
def test_checkpoint_round_trip_is_byte_exact(runs, mode):
    slam = runs[mode]
    path = slam.finalize(mesh=False)
    assert path.endswith("00005.npz")
    fresh = SLAMSystem(slam.cfg, seed=1, device="cpu")
    assert fresh.resume() == slam.n_img
    a, b = slam.store, fresh.store
    n = a.count
    assert b.count == n and b.frame_ids == a.frame_ids
    assert b.has_depthless == a.has_depthless
    for name, x, y in zip(("color", "depth", "inv_q"), a.wire(), b.wire()):
        assert torch.equal(x[:n], y[:n]), name
    for name in ("est_c2w", "gt_c2w"):
        assert torch.equal(getattr(a, name)[:n], getattr(b, name)[:n]), name
    assert torch.equal(slam.est, fresh.est)
    assert torch.equal(slam.map_state.sdf_atlas, fresh.map_state.sdf_atlas)


def test_host_staged_finalize_meshes_from_host_depths(runs, monkeypatch):
    calls = []
    real = mesher.backproject_keyframes

    def counted(store, cam, *a, **k):
        calls.append(store.count)
        return real(store, cam, *a, **k)

    monkeypatch.setattr(mesher, "backproject_keyframes", counted)
    slam = runs["host_staged"]
    slam.finalize()
    assert calls == [6]
    v, f, c = ply.read_ply(os.path.join(slam.output, "mesh",
                                        "final_mesh.ply"))
    assert len(f) > 100 and c is not None and f.max() < len(v)
    _, cf, _ = ply.read_ply(slam.final_mesh)
    assert 0 < len(cf) <= len(f)
    assert set(slam.mesher.stages) >= {"hull", "sdf_volume", "marching"}


def test_bench_host_mode_lines(tmp_path, capsys):
    from myslam_torch.tools import bench_host_mode

    tiny_config(tmp_path)
    cfg_path = tmp_path / "tiny.yaml"  # written by tiny_config
    recs = bench_host_mode.main([
        "--config", str(cfg_path), "--frames", "3", "--warmup", "1",
        "--device", "cpu", "--modes", "tpu", "cpu", "host_staged",
        "--output", str(tmp_path / "bench")])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert lines == recs and [r["store"] for r in recs] == [
        "device", "packed", "host_staged"]
    keys = {"mode", "store", "device", "frames", "warmup", "cam",
            "steady_ms_per_mapped_frame", "fps", "ate_rmse_cm",
            "store_imagery_bytes", "wall_s"}
    for r in recs:
        assert keys <= set(r) and r["device"] == "cpu"
        assert r["fps"] > 0 and np.isfinite(r["ate_rmse_cm"])
    assert recs[1]["store_imagery_bytes"] * 2 == recs[0][
        "store_imagery_bytes"]
    assert {"cache_lines", "cache_misses", "selection_fetches"} <= set(
        recs[2]) and recs[2]["selection_fetches"] == 3
