"""The port's dataset readers against the JAX package's, on the same files.

Layouts are written by the JAX package's exporter (OpenCV's codec) and
read by both packages' readers: Replica, ScanNet (frames 3 and 5 with
-inf poses, crop_edge 10) and TUM (depth holes, crop_size, crop_edge and
a zero distortion, so the undistort path runs).  Stated tolerances:
depth and poses exact; color exact too (the port's JPEG decoder matches
OpenCV's bit for bit, tests/test_torch_imageio.py).  Also: TUM's
association and rebase on hand-written lists, ``get_dataset`` with an
``input_folder`` for every config in the repo, the keyframe capacity
against JAX's padded one on ScanNet's 460x620 crop, the ScanNet invalid
frames masked by both packages' ATE, and the port's own exporter read
back by both readers.
"""

import glob
import os

import numpy as np
import pytest
import torch

from myslam_torch.utils import datasets as tdata
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
from myslam_tpu.utils import datasets as jdata

torch.set_num_threads(2)  # several test workers share the CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOM = os.path.join(REPO, "configs", "Synthetic", "room.yaml")


def _room(H, W, n_frames, **cam):
    cfg = load_config(ROOM, DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = n_frames
    f = 0.75 * W
    cfg["cam"].update(H=H, W=W, fx=f, fy=f, cx=(W - 1) / 2, cy=(H - 1) / 2,
                      **cam)
    return cfg


def _reader_cfg(base: str, room: dict, data: str, **cam) -> dict:
    cfg = load_config(os.path.join(REPO, "configs", base), DEFAULT_CONFIG)
    cfg["cam"].update({k: room["cam"][k] for k in
                       ("H", "W", "fx", "fy", "cx", "cy")}, **cam)
    cfg["data"] = {"input_folder": data, "output": data + "_out"}
    return cfg


def _assert_same_frames(jds, tds):
    assert len(jds) == len(tds) and jds.frame_hw == tds.frame_hw
    for i in range(len(jds)):
        jc, jd, jp = jds.get_frame(i)
        tc, td, tp = tds.get_frame(i)
        assert td.dtype == jd.dtype == np.float32 and tc.dtype == jc.dtype
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tc, jc)
    for a, b in zip(jds.poses, tds.poses):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """The JAX exporter's Replica, ScanNet and TUM layouts of the room."""
    from myslam_tpu.tools import export_synthetic as jexp

    root = tmp_path_factory.mktemp("layouts")
    out = {}
    room = _room(40, 56, 4)
    jexp.export_replica(room, str(root / "replica"), holes=True)
    out["replica"] = (room, str(root / "replica"))
    room = _room(48, 64, 7)
    jexp.export_scannet(room, str(root / "scannet"), invalid_frames=(3, 5),
                        holes=True)
    out["scannet"] = (room, str(root / "scannet"))
    room = _room(48, 64, 5)
    jexp.export_tum(room, str(root / "tum"), holes=True)
    out["tum"] = (room, str(root / "tum"))
    return out


def test_replica_reader_matches_jax(layouts):
    room, data = layouts["replica"]
    cfg = _reader_cfg("Replica/replica.yaml", room, data)
    jds = jdata.get_dataset(cfg, data)
    tds = tdata.get_dataset(cfg, data)
    assert type(tds).__name__ == "Replica" and len(tds) == 4
    _assert_same_frames(jds, tds)
    # The reader recovers the exporter's poses; holes come from the file.
    syn = tdata.Synthetic(room)
    for i in range(len(tds)):
        np.testing.assert_allclose(tds.poses[i], syn.poses[i], atol=1e-6)
    assert (tds.get_frame(1)[1] == 0).any()


def test_scannet_reader_matches_jax_and_ate_masks_invalid_frames(layouts):
    from myslam_torch.tools.eval_ate import evaluate_run as t_eval
    from myslam_tpu.tools.eval_ate import evaluate_run as j_eval

    room, data = layouts["scannet"]
    cfg = _reader_cfg("ScanNet/scannet.yaml", room, data)
    assert cfg["cam"]["crop_edge"] == 10
    jds = jdata.get_dataset(cfg, data)
    tds = tdata.get_dataset(cfg, data)
    assert type(tds).__name__ == "ScanNet" and tds.frame_hw == (28, 44)
    _assert_same_frames(jds, tds)
    gt = np.stack(tds.poses)
    assert [i for i in range(len(gt)) if not np.isfinite(gt[i]).all()] \
        == [3, 5]
    est = np.stack(tdata.Synthetic(room).poses) + np.float32(0.01) * \
        np.random.default_rng(0).normal(size=gt.shape).astype(np.float32)
    ours, theirs = t_eval(est, gt), j_eval(est, gt)
    assert ours == theirs and ours["compared_pose_pairs"] == len(gt) - 2


def test_scannet_frame_zero_must_be_valid(tmp_path):
    from myslam_tpu.tools.export_synthetic import export_scannet

    room = _room(24, 32, 2)
    export_scannet(room, str(tmp_path), invalid_frames=(0,))
    cfg = _reader_cfg("ScanNet/scannet.yaml", room, str(tmp_path))
    with pytest.raises(ValueError, match="frame 0"):
        tdata.get_dataset(cfg, str(tmp_path))


def test_tum_reader_matches_jax_with_crop_and_undistortion(layouts):
    room, data = layouts["tum"]
    cfg = _reader_cfg("TUM_RGBD/tum.yaml", room, data,
                      crop_size=[40, 52], crop_edge=3,
                      distortion=[0.0] * 5)
    jds = jdata.get_dataset(cfg, data)
    tds = tdata.get_dataset(cfg, data)
    assert type(tds).__name__ == "TUMRGBD" and tds.frame_hw == (34, 46)
    _assert_same_frames(jds, tds)
    np.testing.assert_array_equal(
        tds.poses[0], np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32))
    assert (tds.get_frame(2)[1] == 0).any()


def test_tum_association_and_rebase_on_hand_written_lists(tmp_path):
    """Images without a depth or pose within 0.08 s are dropped; images
    closer than 1/32 s to the last kept one are skipped; the first kept
    pose becomes the identity (then the column flip)."""
    rgb = [0.00, 0.01, 0.05, 0.10, 0.20, 0.30, 0.50, 0.60]
    depth = [0.00, 0.11, 0.21, 0.45, 0.61]
    pose = [0.0, 0.1, 0.2, 0.3, 0.44, 0.6]
    (tmp_path / "rgb.txt").write_text("\n".join(
        f"{t:.6f} rgb/{t:.6f}.png" for t in rgb) + "\n")
    (tmp_path / "depth.txt").write_text("\n".join(
        f"{t:.6f} depth/{t:.6f}.png" for t in depth) + "\n")
    rng = np.random.default_rng(4)
    lines = ["# timestamp tx ty tz qx qy qz qw"]
    for t in pose:
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        lines.append(f"{t:.6f} " + " ".join(
            f"{v:.9f}" for v in list(rng.normal(size=3)) + list(q)))
    (tmp_path / "groundtruth.txt").write_text("\n".join(lines) + "\n")
    t = tdata.TUMRGBD._load_tum(tdata.TUMRGBD, str(tmp_path), 32)
    j = jdata.TUMRGBD._load_tum(jdata.TUMRGBD, str(tmp_path), 32)
    assert t[0] == j[0] and t[1] == j[1]
    for a, b in zip(t[2], j[2]):
        np.testing.assert_array_equal(a, b)
    kept = [os.path.basename(p) for p in t[0]]
    # 0.01: within 1/32 s of 0.00; 0.30: its nearest depth is 0.09 s off
    assert kept == ["0.000000.png", "0.050000.png", "0.100000.png",
                    "0.200000.png", "0.500000.png", "0.600000.png"]
    np.testing.assert_array_equal(
        t[2][0], np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32))
    assert tdata.TUMRGBD.associate_frames(
        np.array(rgb), np.array(depth), np.array(pose)) == \
        jdata.TUMRGBD.associate_frames(np.array(rgb), np.array(depth),
                                       np.array(pose))


def test_get_dataset_with_an_input_folder_for_every_config(layouts):
    """Every config of the repo names a dataset the port reads; a disk
    dataset takes ``input_folder`` over its config's; Synthetic ignores
    it."""
    configs = sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yaml")))
    assert len(configs) >= 20
    kinds = {"replica": "Replica", "scannet": "ScanNet", "tumrgbd": "TUM",
             "synthetic": "Synthetic"}
    seen = set()
    for path in configs:
        cfg = load_config(path, DEFAULT_CONFIG)
        name = cfg["dataset"]
        seen.add(name)
        layout = {"tumrgbd": "tum"}.get(name, name)
        folder = layouts[layout][1] if layout in layouts else "/nonexistent"
        tds = tdata.get_dataset(cfg, folder)
        assert type(tds).__name__.startswith(kinds[name]), path
        if name == "synthetic":
            continue
        jds = jdata.get_dataset(cfg, folder)
        assert tds.input_folder == folder and len(tds) == len(jds) > 0
        assert tds.frame_hw == jds.frame_hw
    assert seen == set(kinds)
    with pytest.raises(ValueError, match="unknown dataset"):
        tdata.get_dataset({"dataset": "kitti"})


def test_capacity_pads_as_jax_does_on_the_scannet_crop(tmp_path):
    """ScanNet's 480x640 less crop_edge 10 is 460x620, whose flattened
    imagery divides into 128-lane rows only 8 frames at a time: the
    port's store takes the JAX package's padded capacity (the window
    selector draws over it)."""
    from myslam_torch.engine.scheduler import SLAMSystem as TSystem
    from myslam_tpu.engine.scheduler import SLAMSystem as JSystem
    from myslam_tpu.tools.export_synthetic import export_scannet

    room = _room(480, 640, 2)
    export_scannet(room, str(tmp_path / "data"))
    cfg = _reader_cfg("ScanNet/scannet.yaml", room, str(tmp_path / "data"))
    cfg["mapping"]["bound"] = cfg["mapping"]["marching_cubes_bound"] = [
        [-0.2, 4.2], [-0.2, 3.2], [-0.2, 2.7]]
    cfg["model"]["c_dim"] = 8
    out = str(tmp_path / "out")
    j = JSystem(cfg, input_folder=str(tmp_path / "data"), output=out)
    t = TSystem(cfg, input_folder=str(tmp_path / "data"), output=out,
                device="cpu")
    assert (t.cam.H, t.cam.W) == (460, 620)
    assert t.store.capacity == j.store.capacity == 8
    assert t.scratch_slot == 7


def test_port_exporter_layouts_read_back_by_both_readers(tmp_path):
    """The port's exporter (its own codec): depth files and poses as the
    JAX exporter writes them, and color that both readers decode alike
    (the port's JPEG encoder is not OpenCV's, so the files differ)."""
    from myslam_torch.tools import export_synthetic as texp
    from myslam_tpu.tools import export_synthetic as jexp

    room = _room(40, 56, 3)
    for layout, base in (("replica", "Replica/replica.yaml"),
                         ("tum", "TUM_RGBD/tum.yaml")):
        mine, theirs = tmp_path / f"t_{layout}", tmp_path / f"j_{layout}"
        getattr(texp, f"export_{layout}")(room, str(mine), holes=True)
        getattr(jexp, f"export_{layout}")(room, str(theirs), holes=True)
        cfg = _reader_cfg(base, room, str(mine))
        tds = tdata.get_dataset(cfg, str(mine))
        _assert_same_frames(jdata.get_dataset(cfg, str(mine)), tds)
        ref = tdata.get_dataset(cfg, str(theirs))
        for i in range(len(tds)):
            tc, td, tp = tds.get_frame(i)
            rc, rd, rp = ref.get_frame(i)
            np.testing.assert_array_equal(td, rd)
            np.testing.assert_array_equal(tp, rp)
            if layout == "tum":  # PNG color: lossless in both
                np.testing.assert_array_equal(tc, rc)
            else:  # two quality-98 JPEG encoders
                assert np.abs(tc - rc).mean() <= 1.5 / 255
    A = texp.tum_world_transform(room)
    np.testing.assert_allclose(A, jexp.tum_world_transform(room), atol=0)
    assert texp.transform_bound(room["mapping"]["bound"], A) == \
        jexp.transform_bound(room["mapping"]["bound"], A)
