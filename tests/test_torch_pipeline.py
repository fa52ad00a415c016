"""The track||map pipeline (``parallel.pipeline``,
``myslam_torch/parallel/pipeline.py``) on CPU gangs of gloo ranks.

The JAX package's pipeline runs on one process's submeshes; its own test
costs ~140 s per run on 8 virtual devices, so the 2-rank pipeline is held
against the port's one-process run of the same stale-snapshot schedule
(the tracker and mapper it drives are held against JAX elsewhere), and
the JAX package's gates (``tests/test_pipeline.py:47-59``) against the
port's serial run:

  * a 2-rank pipeline (one tracking rank, one mapping rank) ends with the
    one-process schedule's trajectory and map, bit for bit, having sent
    one pose group per mapped frame and one snapshot per mapped frame
    but the last;
  * the one-process schedule against the serial loop on 13 frames at
    48x64: every frame within 5 cm of the ground truth, within 2 cm of
    the serial run, and an RMSE no worse than twice the serial run's plus
    0.5 mm;
  * ``pipeline_map_devices: 2`` (3 ranks, ray DP over the mapping
    ranks) runs within the same gates;
  * the one-process schedule's checkpoint at frame 4, resumed by a
    2-rank gang, ends on the uninterrupted trajectory and map bit for
    bit;
  * the staleness itself against the JAX package's scheduler: with the
    tracker and the mapper replaced by stubs (the mapper stamps the map
    with its frame, the tracker reads the stamp), every tracked frame
    renders against the same mapped frame's map in the port's pipeline
    as in JAX's (``_map_frame_pipeline``, 1 + 1 virtual devices).

The scene is the synthetic room at 24x32 (48x64 for the gates) with the
packed keyframe store (its checkpoints hold the store byte for byte) and
one thread per rank (the one-process runs too, so that float sums match
bit for bit).  The first and the fourth case share one one-process run
and one 2-rank gang (``nine``).
"""

import os

import numpy as np
import pytest
import torch
import yaml

from myslam_torch.engine.scheduler import SLAMSystem
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
from torch_gang import each, run_ranks, system_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(tmp_path, frames, parallel, name="cfg", gate=False) -> str:
    """The room at 24x32 under ``parallel``: mapped frames every 4th and
    the last, a checkpoint at frame 4.  ``gate``: at 48x64 with finer
    planes and a longer first frame, where tracking holds the room's
    motion (at 24x32 even the serial run drifts ~1 cm per frame) and the
    JAX package's gates mean something."""
    cfg = {
        "inherit_from": os.path.join(REPO, "configs", "Synthetic",
                                     "room.yaml"),
        "keyframe_device": "cpu",
        "data": {"n_frames": frames},
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5},
        "model": {"c_dim": 8},
        "planes_res": {"coarse": 0.48, "fine": 0.24},
        "c_planes_res": {"coarse": 0.48, "fine": 0.12},
        "tracking": {"pixels": 64, "iters": 4, "ignore_edge_H": 2,
                     "ignore_edge_W": 2},
        "mapping": {"pixels": 128, "iters_first": 30, "iters": 4,
                    "ckpt_freq": 4},
        "parallel": parallel,
    }
    if gate:
        cfg.update({
            "cam": {"H": 48, "W": 64, "fx": 40.0, "fy": 40.0, "cx": 31.5,
                    "cy": 23.5},
            "planes_res": {"coarse": 0.24, "fine": 0.12},
            "c_planes_res": {"coarse": 0.24, "fine": 0.06},
            "rendering": {"n_stratified": 12, "n_importance": 4}})
        cfg["tracking"].update(pixels=192, iters=8)
        cfg["mapping"].update(pixels=192, iters_first=100)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def one_process(cfg_path, out):
    """SLAMSystem in this process with one thread, as a rank runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        slam = SLAMSystem(load_config(cfg_path, DEFAULT_CONFIG),
                          output=str(out), device="cpu")
        slam.run(finalize=False)
    finally:
        torch.set_num_threads(threads)
    return slam


def gates(est, serial_est, gt):
    """The JAX package's pipeline gates (tests/test_pipeline.py:47-59)."""
    assert np.isfinite(est).all()
    ate = np.linalg.norm(est[1:, :3, 3] - gt[1:, :3, 3], axis=-1)
    ate_serial = np.linalg.norm(serial_est[1:, :3, 3] - gt[1:, :3, 3],
                                axis=-1)
    assert ate.max() < 0.05, ate
    d = np.linalg.norm(est[:, :3, 3] - serial_est[:, :3, 3], axis=-1)
    assert d.max() < 0.02, d
    assert np.sqrt((ate ** 2).mean()) < \
        2.0 * np.sqrt((ate_serial ** 2).mean()) + 5e-4


@pytest.fixture(scope="module")
def nine(tmp_path_factory):
    """The 9-frame pipeline config, its one-process run (``ref``, in
    ``out``, where it leaves the checkpoint of frame 4), and one gang of
    2 ranks that runs it from the start into ``gang`` and then resumes
    it in ``out``: the gang's two outputs per rank."""
    tmp = tmp_path_factory.mktemp("nine")
    cfg = config(tmp, 9, {"pipeline": True})
    out = tmp / "run"
    ref = one_process(cfg, out)
    ckpts = sorted(os.listdir(out / "ckpts"))
    with np.load(out / "ckpts" / "00004.npz") as ck:
        fields = set(ck.files)
    outs = run_ranks(each, 2, [(system_case, (cfg, str(tmp / "gang"))),
                               (system_case, (cfg, str(out), True))],
                     timeout=240)
    return {"tmp": tmp, "ref": ref, "ckpts": ckpts, "fields": fields,
            "outs": outs}


def test_pipeline_is_its_one_process_schedule(nine):
    ref = nine["ref"]
    outs = [rank[0] for rank in nine["outs"]]
    assert [o["role"] for o in outs] == ["track", "map"]
    for out in outs:
        np.testing.assert_array_equal(out["est"], ref.estimates)
    for k in ("sdf_atlas", "color_atlas"):
        np.testing.assert_array_equal(
            outs[1]["map"][k], ref.map_state.__dict__[k].detach().numpy())
    # Mapped frames 0, 4 and 8: a pose group each, snapshots after the
    # first two (none is needed after the last).
    for out in outs:
        assert out["counts"]["poses"]["calls"] == 3 + 1  # + the final one
        assert out["counts"]["snapshot"]["calls"] == 2
    # The map role wrote the checkpoint, into rank 0's folder.
    assert os.path.exists(nine["tmp"] / "gang" / "ckpts" / "00004.npz")


def test_pipeline_resumes_bit_for_bit(nine):
    ref = nine["ref"]
    assert nine["ckpts"] == ["00004.npz"]
    assert {"pipeline_track_est", "pipeline_snapshot"} <= nine["fields"]
    outs = [rank[1] for rank in nine["outs"]]
    for o in outs:
        assert o["start"] == 5
        np.testing.assert_array_equal(o["est"], ref.estimates)
    np.testing.assert_array_equal(outs[1]["map"]["sdf_atlas"],
                                  ref.map_state.sdf_atlas.detach().numpy())


@pytest.fixture(scope="module")
def serial(tmp_path_factory):
    """The serial loop on the gates' 13 frames."""
    tmp = tmp_path_factory.mktemp("serial")
    return one_process(config(tmp, 13, {}, "serial", gate=True),
                       tmp / "out")


def test_pipeline_within_jax_gates_of_serial(tmp_path, serial):
    pipe = one_process(config(tmp_path, 13, {"pipeline": True}, "pipe",
                              gate=True), tmp_path / "pipe")
    gates(pipe.estimates, serial.estimates, serial.gt_poses)
    # Stale snapshots change the tracked poses: the two runs differ.
    assert np.abs(pipe.estimates - serial.estimates).max() > 0


def test_pipeline_with_two_mapping_ranks(tmp_path, serial):
    cfg = config(tmp_path, 13, {"pipeline": True,
                                "pipeline_track_devices": 1,
                                "pipeline_map_devices": 2}, gate=True)
    outs = run_ranks(system_case, 3, cfg, str(tmp_path / "gang"),
                     timeout=240)
    assert [o["role"] for o in outs] == ["track", "map", "map"]
    for out in outs:
        np.testing.assert_array_equal(out["est"], outs[0]["est"])
    np.testing.assert_array_equal(outs[1]["map"]["sdf_atlas"],
                                  outs[2]["map"]["sdf_atlas"])
    # Ray DP over the two mapping ranks: a gradient all-reduce per
    # mapping iteration (100 + 3 x 4), on the map role alone.
    assert outs[1]["counts"]["grad"]["calls"] == 112
    assert "grad" not in outs[0]["counts"]
    gates(outs[0]["est"], serial.estimates, serial.gt_poses)


def stamped_frames(tmp_path, frames, every, port: bool) -> dict:
    """{tracked frame: the mapped frame whose map it rendered against (-1:
    the initial map)} of a pipeline run of ``frames`` frames mapping
    every ``every``-th, the port's one-process schedule or the JAX
    package's, with the tracker and the mapper replaced by stubs: the
    mapper writes its frame + 1 into the SDF atlas, the tracker reads
    it."""
    cfg_path = config(tmp_path, frames, {
        "pipeline": True, "pipeline_track_devices": 1,
        "pipeline_map_devices": 1}, name="jax" if not port else "port")
    seen = {}
    if port:
        cfg = load_config(cfg_path, DEFAULT_CONFIG)
        cfg["mapping"].update(every_frame=every, ckpt_freq=10 ** 6,
                              mesh_freq=10 ** 6)
        slam = SLAMSystem(cfg, output=str(tmp_path / "port"), device="cpu")

        def mapper(ms, *args, **kw):
            with torch.no_grad():
                ms.sdf_atlas.fill_(args[6] + 1)  # the frame
            return torch.zeros(2)

        def tracker(ms, est, idx0, px_i, *args):
            g = px_i.shape[0]
            for i in range(g):
                seen[idx0 + i] = int(ms.sdf_atlas.reshape(-1)[0]) - 1
            return None, torch.zeros(g), torch.zeros(g), \
                torch.zeros((g, 1, 7))

        slam.group_tracker = tracker
    else:
        import jax.numpy as jnp

        from myslam_tpu.engine.scheduler import SLAMSystem as JaxSLAM
        from myslam_tpu.utils.config import load_config as jax_load

        cfg = jax_load(cfg_path, DEFAULT_CONFIG)
        cfg["mapping"].update(every_frame=every, ckpt_freq=10 ** 6,
                              mesh_freq=10 ** 6)
        slam = JaxSLAM(cfg, output=str(tmp_path / "jax"))

        class mapper:  # noqa: N801 (the mapper's contract: callable)
            @staticmethod
            def jit_init(tree):
                return None

            def __call__(self, ms, opt, est, *args, **kw):
                ms = ms.replace(sdf_atlas=jnp.full_like(ms.sdf_atlas,
                                                        args[8] + 1))
                return (ms, opt, est, *args[:4], jnp.zeros((2,)))

        def track_group(ms, est, idx0, px_i, *args):
            g = px_i.shape[0]
            for i in range(g):
                seen[int(idx0) + i] = int(ms.sdf_atlas.ravel()[0]) - 1
            return est, jnp.zeros((g, 4, 4)), jnp.zeros((g,)), \
                jnp.zeros((g,)), jnp.zeros((g, 1, 7))

        def track(ms, est, idx, *args):  # a group shorter than every_frame
            seen[int(idx)] = int(ms.sdf_atlas.ravel()[0]) - 1
            return est, None, jnp.zeros(()), jnp.zeros(()), None

        mapper = mapper()
        slam.group_tracker, slam.tracker = track_group, track
    slam._mappers = {False: mapper, True: mapper}
    slam.run_loop()
    return seen


@pytest.mark.parametrize("frames,every", [(13, 4), (12, 5)])
def test_pipeline_snapshots_are_jax_schedule(tmp_path, frames, every):
    port = stamped_frames(tmp_path, frames, every, port=True)
    jax_seen = stamped_frames(tmp_path, frames, every, port=False)
    assert port == jax_seen
    assert sorted(port) == list(range(1, frames))
    # Stale: the group after a mapped frame f > 0 renders against the
    # map of the mapped frame before f (frame 0's group against map(0)).
    assert port[every + 1] == 0 and port[2 * every + 1] == every
