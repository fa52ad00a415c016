"""The port's benchmark path: tools/bench_scatter.py, checkpoints
(utils/logger.py with SLAMSystem.finalize/resume) and bench_torch.py,
on the CPU at a tiny size.

  * bench_scatter's gather and scatter lines at n = 64 on the plain
    paths: every line within 1e-5 of its reference line (bfloat16 lines
    within 1e-2), and the scatter strategies against JAX's
    ``zeros.at[cell].add(upd)`` on the same numpy inputs (float32 lines
    atol 1e-5; bfloat16 lines within 1e-2 of the largest value);
  * a checkpoint round trip on room_smoke.yaml cut to 2 frames with 2
    mapping and 2 tracking iterations (``finalize`` also writes the mesh,
    at 0.25 m, and its culled copy): atlases, decoder, poses, keyframe
    colors and the draw source bit for bit, depths within half their
    quantization step, the right start index, and interrupted writes
    ignored;
  * ``decoder_leaves`` in jax.tree_util.tree_flatten order;
  * ``bench_torch.run_lane``: exactly bench.py's record keys, the
    window-level fps rule, and no compile time from an earlier build.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from myslam_torch.tools import bench_scatter as bs

torch.set_num_threads(2)  # several test workers share the CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_lines_agree_on_the_cpu():
    recs = (bs.bench_gather(64, 0, "cpu", log=lambda s: None)
            + bs.bench_scatter(64, 0, "cpu", log=lambda s: None))
    names = [r["name"] for r in recs]
    assert [names.count(k) for k in ("plain_f32", "smem_bf16", "k1_f32")] \
        == [2, 2, 2]
    assert names.count("onehot_bf16") == 1  # 18,368 rows only
    for r in recs:
        assert r["ms"] is None  # nothing is timed off the GPU
        limit = 1e-2 if "bf16" in r["name"] else 1e-5
        assert r["rel_err"] <= limit, r
        if r["name"] == "smem_bf16":
            assert r["rel_err"] > 1e-5  # the bf16 rounding is there
            assert r["rel_err_vs_k1_bf16"] <= 1e-5


@pytest.mark.parametrize("rows", [r for r, _ in bs.SCATTER_ROWS])
def test_scatter_strategies_match_jax(rows):
    rng = np.random.default_rng(rows)
    n = 500
    cell = rng.integers(0, rows, size=n).astype(np.int32)
    cell[:50] = cell[0]  # a row hit many times
    upd = rng.normal(size=(n, bs.SCATTER_WIDTH)).astype(np.float32)
    ref = np.asarray(jnp.zeros((rows, bs.SCATTER_WIDTH), jnp.float32)
                     .at[jnp.asarray(cell)].add(jnp.asarray(upd)))
    strategies = bs.scatter_strategies(rows, "cpu")
    assert len(strategies) == (6 if rows <= bs.ONEHOT_MAX_ROWS else 5)
    for name, fn in strategies:
        got = fn(torch.tensor(cell, dtype=torch.int64),
                 torch.tensor(upd)).numpy()
        assert got.shape == ref.shape and got.dtype == np.float32
        if "bf16" in name:
            assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max(), name
        else:
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0,
                                       err_msg=name)


def _tiny_config(tmp_path):
    cfg = {
        "inherit_from": os.path.join(REPO, "configs", "Synthetic",
                                     "room_smoke.yaml"),
        "data": {"n_frames": 2, "output": str(tmp_path / "out")},
        "tracking": {"iters": 2},
        "mapping": {"iters_first": 2, "iters": 2},
        "meshing": {"resolution": 0.25},
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_checkpoint_round_trip(tmp_path, monkeypatch):
    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.utils import logger
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
    from myslam_torch.utils.ply import read_ply

    cfg = load_config(_tiny_config(tmp_path), DEFAULT_CONFIG)
    slam = SLAMSystem(cfg, seed=3, device="cpu")
    slam.run(finalize=False)
    ckpt_dir = os.path.join(slam.output, "ckpts")
    assert logger.latest_checkpoint(ckpt_dir) is None
    path = slam.finalize(checkpoint=True)
    assert path == os.path.join(ckpt_dir, "00001.npz")
    mesh_dir = os.path.join(slam.output, "mesh")
    assert slam.final_mesh == os.path.join(mesh_dir, "final_mesh_culled.ply")
    _, faces, _ = read_ply(os.path.join(mesh_dir, "final_mesh.ply"))
    assert len(faces) > 0 and len(read_ply(slam.final_mesh)[1]) > 0

    # A write cut before its rename leaves only a .tmp.npz, which is
    # never picked up, even with a later frame number.
    def crash(*a, **k):
        raise OSError("killed")

    monkeypatch.setattr(logger.os, "replace", crash)
    with pytest.raises(OSError):
        logger.save_checkpoint(os.path.join(ckpt_dir, "00009.npz"), slam, 9)
    monkeypatch.undo()
    assert os.path.exists(os.path.join(ckpt_dir, "00009.npz.tmp.npz"))
    assert logger.latest_checkpoint(ckpt_dir) == path

    fresh = SLAMSystem(cfg, seed=11, device="cpu")
    assert fresh.resume() == slam.n_img
    a, b = slam.map_state, fresh.map_state
    assert torch.equal(a.sdf_atlas, b.sdf_atlas)
    assert torch.equal(a.color_atlas, b.color_atlas)
    for (k, va), (_, vb) in zip(a.decoder.state_dict().items(),
                                b.decoder.state_dict().items()):
        assert torch.equal(va, vb), k
    assert torch.equal(slam.est, fresh.est)
    np.testing.assert_array_equal(slam.gt_poses, fresh.gt_poses)
    s, f = slam.store, fresh.store
    n = s.count
    assert n == f.count == 1 and f.frame_ids == s.frame_ids == [0]
    assert f.has_depthless[:n] == s.has_depthless[:n]
    assert torch.equal(s.colors[:n], f.colors[:n])
    assert torch.equal(s.est_c2w[:n], f.est_c2w[:n])
    assert torch.equal(s.gt_c2w[:n], f.gt_c2w[:n])
    step = float(s.depths[:n].max()) / 60000.0
    assert float((s.depths[:n] - f.depths[:n]).abs().max()) <= 0.5 * step
    assert torch.equal(slam.draws.generator.get_state(),
                       fresh.draws.generator.get_state())
    assert fresh.draws.uniform((4,)).tolist() == \
        slam.draws.uniform((4,)).tolist()


def test_decoder_leaves_follow_jax_tree_order():
    from myslam_tpu.models.decoders import init_decoder_params
    from myslam_torch.models.convert import decoder_from_jax_numpy
    from myslam_torch.utils.logger import decoder_leaves

    jdec = init_decoder_params(jax.random.PRNGKey(0), c_dim=8)
    jleaves = jax.tree_util.tree_leaves(jdec)
    ours = decoder_leaves(decoder_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, jdec)))
    assert len(ours) == len(jleaves) == 13
    for got, ref in zip(ours, jleaves):
        np.testing.assert_array_equal(got, np.asarray(ref))


def _bench_record_keys():
    """The keys of the record bench.py's run_lane builds."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "rec"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record in bench.py")


def test_run_lane_record_and_fps_rule(tmp_path, monkeypatch):
    import bench_torch
    from myslam_torch.ops import cuda_sample

    # A build earlier in the process is not the lane's compile time.
    monkeypatch.setattr(cuda_sample, "BUILD_SECONDS", 6.5)

    args = bench_torch.parse_args([
        "--config", _tiny_config(tmp_path), "--frames", "2",
        "--warmup-frames", "1", "--device", "cpu", "--lanes", "exact",
        "--output", str(tmp_path / "bench")])
    rec, slam = bench_torch.run_lane(args, exact=True, seed=0)
    assert set(rec) == _bench_record_keys()
    assert rec["math"].startswith("reference-exact")
    assert slam.scene.color_topk == 0
    assert len(slam.frame_start_wall) == len(slam.frame_log) == 2
    span = slam.drain_wall - slam.frame_start_wall[1]
    assert rec["value"] == round(1 / span, 3)
    assert rec["frames"] == 2 and np.isfinite(rec["ate_rmse_cm"])
    assert rec["compile_backend_s"] == 0.0 and slam.compile_secs == 0.0
    assert all(r["frame_ms"] > 0 for r in slam.frame_log)
