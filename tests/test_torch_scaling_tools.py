"""The scaling tools of the port (ROADMAP A3), on the CPU.

  * (f) ``tools/scaling_report.py``: ``atlas_grad_bytes``, ``project_dp``
    and ``project_pipeline`` against the JAX package's on the same
    arguments (the port's have no defaults of TPU figures: the link rate
    and the host's ms per frame are passed to both), the report built
    from measured inputs written as the port's tools write them, the
    refusal of the repository root's TPU records and of a missing input;
    and the payload against the gradient bytes a CPU gang all-reduced.
  * (g) ``tools/validate_scaling.py --smoke --device cpu --devices 2``:
    one iteration of ``room_smoke.yaml``'s window on 2 ranks.  Plain DP:
    one all-reduce of the flat gradient, ratio 1.00 (the model leaves
    out the window poses and 15 decoder floats); ZeRO: the same bytes
    reduced (gloo: an all-reduce) and both atlases' padded row blocks
    all-gathered.
  * ``tools/bench_pose_solver.py`` on the CPU at a 1 s budget, one shard,
    chunks of 2 iterations, the map trained for 5 iterations a round.

Projections agree to 1e-9 relative (the same float64 formulas); byte
counts exactly.
"""

import json

import numpy as np
import pytest
import torch

from myslam_tpu.tools import scaling_report as jsr
from myslam_torch.tools import bench_pose_solver, scaling_report, \
    validate_scaling
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

torch.set_num_threads(2)  # several test workers share the CPU

SMOKE = "configs/Synthetic/room_smoke.yaml"


@pytest.fixture(scope="module")
def validated():
    return validate_scaling.main(["--smoke", "--device", "cpu",
                                  "--devices", "2", "--json"])


def exact_payload(cfg, window):
    """The port's flat gradient buffer: both atlases, every decoder
    parameter, beta, the window's poses; float32."""
    import torch

    from myslam_torch.models.config import get_model
    from myslam_torch.render.renderer import scene_from_cfg

    scene = scene_from_cfg(cfg)
    dec = get_model(cfg, torch.Generator().manual_seed(0))
    n = (scene.sdf_layout.total_rows * scene.sdf_layout.c_dim
         + scene.color_layout.total_rows * scene.color_layout.c_dim
         + sum(p.numel() for p in dec.mlp_params()) + 1 + 7 * window)
    return 4 * n


def test_scaling_report_matches_jax(tmp_path, validated):
    """(f) The model's functions against JAX's, the report from measured
    inputs, the refusals, and the payload against a gang's bytes."""
    for path in ("configs/Synthetic/room.yaml", SMOKE):
        cfg = load_config(path, DEFAULT_CONFIG)
        assert scaling_report.atlas_grad_bytes(cfg) == \
            jsr.atlas_grad_bytes(cfg)
    args = dict(map_iter_ms=12.5, map_opt_ms=0.6, track_iter_ms=9.0,
                grad_bytes=7591188, map_iters=15, track_iters=8,
                every_frame=4, fixed_ms_per_frame=3.5)
    for n in (1, 2, 8):
        for zero in (True, False):
            for floor in (0.0, 6.0):
                kw = dict(args, zero_opt=zero, floor_ms=floor)
                np.testing.assert_allclose(
                    scaling_report.project_dp(n, link_gbps=20.0, **kw),
                    jsr.project_dp(n, ici_gbps=20.0, **kw), rtol=1e-9)
                np.testing.assert_allclose(
                    scaling_report.project_pipeline(1, n, link_gbps=20.0,
                                                    **kw),
                    jsr.project_pipeline(1, n, ici_gbps=20.0, **kw),
                    rtol=1e-9)
    comp = {"device": "cpu", "track_iter_ms": 9.0,
            "components": {"full_grad": {"ms": 12.5}, "adam": {"ms": 0.6}}}
    sweep = {"lanes": {"topk": {"fit_floor_ms": 6.6}}}
    gang = {"world": 2, "collectives": {"grad": {
        "calls": 15, "bytes": 15 * 7591804, "seconds": 0.15}}}
    metrics = tmp_path / "metrics.jsonl"
    metrics.write_text("".join(json.dumps(r) + "\n" for r in (
        {"frame": 0, "frame_ms": 9000.0},
        {"frame": 1, "frame_ms": 2.0, "track_ms": 1.0},
        {"frame": 2, "frame_ms": 300.0, "track_ms": 100.0,
         "map_ms": 190.0})))
    files = {}
    for name, rec in (("comp", comp), ("sweep", sweep), ("gang", gang)):
        files[name] = str(tmp_path / f"{name}.json")
        with open(files[name], "w") as f:
            json.dump(rec, f)
    rep = scaling_report.main(["--components", files["comp"],
                               "--raysweep", files["sweep"],
                               "--link-from", files["gang"],
                               "--metrics", str(metrics)])
    assert rep["inputs"]["fixed_ms_per_frame"] == 5.5
    np.testing.assert_allclose(rep["inputs"]["link_gbps"],
                               7591804 / 0.01 / 1e9, rtol=1e-12)
    lane = rep["lanes"]["topk"]
    np.testing.assert_allclose(lane["floor_ms"], 6.0, rtol=1e-12)
    cfg = load_config("configs/Synthetic/room.yaml", DEFAULT_CONFIG)
    want = jsr.project_dp(
        4, 12.5, 0.6, 9.0, jsr.atlas_grad_bytes(cfg), 15, 8, 4,
        rep["inputs"]["link_gbps"], fixed_ms_per_frame=5.5, floor_ms=6.0)
    np.testing.assert_allclose(lane["dp_projection"][2]["fps"], want,
                               rtol=1e-9)
    for bad in (["--raysweep", "raysweep.json"],
                ["--components", "perf_profile.json"]):
        argv = ["--components", files["comp"], "--raysweep",
                files["sweep"], "--link-gbps", "10", "--metrics",
                str(metrics)]
        argv[argv.index(bad[0]) + 1] = bad[1]
        with pytest.raises(SystemExit, match="TPU record"):
            scaling_report.main(argv)
    with pytest.raises(SystemExit, match="link"):
        scaling_report.main(["--components", files["comp"], "--raysweep",
                             files["sweep"], "--metrics", str(metrics)])
    # The payload against the bytes a CPU gang all-reduced per iteration.
    smoke = load_config(SMOKE, DEFAULT_CONFIG)
    plain = next(r for r in validated["rows"] if r["impl"] == "shardmap")
    window = int(smoke["mapping"]["mapping_window_size"])
    assert plain["bytes_per_iter"]["grad"] == exact_payload(smoke, window)
    assert abs(plain["bytes_per_iter"]["grad"]
               / scaling_report.atlas_grad_bytes(smoke) - 1.0) < 1e-3


def test_validate_scaling_counts_plain_dp_and_zero(validated):
    """(g) The collectives of plain DP and of ZeRO per iteration on 2
    gloo ranks against the model's payload."""
    smoke = load_config(SMOKE, DEFAULT_CONFIG)
    from myslam_torch.render.renderer import scene_from_cfg

    scene = scene_from_cfg(smoke)
    padded = sum(4 * -(-lay.total_rows // 2) * 2 * lay.c_dim
                 for lay in (scene.sdf_layout, scene.color_layout))
    rows = {r["impl"]: r for r in validated["rows"]}
    assert set(rows) == {"shardmap", "spmd_zero"}
    plain, zero = rows["shardmap"], rows["spmd_zero"]
    assert plain["n"] == zero["n"] == 2 and plain["backend"] == "gloo"
    assert plain["calls_per_iter"] == {"grad": 1.0, "loss": 1.0}
    assert round(plain["ratio_vs_model"]["grad"], 2) == 1.00
    assert round(plain["wire_ratio_vs_model"], 2) == 1.00
    assert zero["calls_per_iter"] == {"grad_rs": 1.0, "grad": 1.0,
                                      "zero_gather": 1.0, "loss": 1.0}
    assert zero["ops"] == {"grad_rs": "reduce-scatter", "grad": "all-reduce",
                           "zero_gather": "all-gather",
                           "loss": "all-reduce"}
    atlases = 4 * sum(lay.total_rows * lay.c_dim
                          for lay in (scene.sdf_layout, scene.color_layout))
    assert zero["bytes_per_iter"]["grad_rs"] == padded
    assert zero["bytes_per_iter"]["grad"] == \
        plain["bytes_per_iter"]["grad"] - atlases
    assert zero["bytes_per_iter"]["zero_gather"] == padded


def test_bench_pose_solver_runs_on_the_cpu():
    """The three solvers each get their second, from the same perturbed
    pose."""
    out = bench_pose_solver.main(["--device", "cpu", "--budget-s", "1",
                                  "--shards", "1", "--chunk", "2",
                                  "--train-iters", "5"])
    assert set(out["solvers"]) == set(bench_pose_solver.SOLVERS)
    assert 0.01 < out["err_initial_m"] < 0.05
    for rec in out["solvers"].values():
        assert rec["iters_done"] >= 2 and rec["wall_s"] >= 1.0
        assert np.isfinite([t["err_m"] for t in rec["trace"]]).all()
    assert out["winner_at_equal_wall"] in bench_pose_solver.SOLVERS
