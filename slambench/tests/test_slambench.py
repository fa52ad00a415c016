"""CPU tests of the benchmark (slambench/): its files found by name, the
contract's names and units, its imports, the frozen counts at a small
shape, a rehearsal of each cell, and the check refusing the control,
the faults a cell can have and a wrong pose update in joint mapping.

    python -m pytest slambench/tests -q

The test marked ``cuda`` runs a cell on the card and skips without one.
"""

import ast
import glob
import importlib
import json
import os
import re
import subprocess
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_contract_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in [e["name"] for e in SPEC["end_to_end"]]
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    names += WORKLOADS + [m["name"] for m in SPEC["end_to_end"]
                          + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(WORKLOADS)) == len(WORKLOADS)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    from slambench import harness

    cell = harness.load_cell(workload)
    assert cell["config"]["cam"]["H"] > 0
    assert {"init_map_mismatch", "store_mismatch", "window_mismatch",
            "track_loss_gap", "track_step_gap", "map_loss_gap",
            "map_step_gap"} <= set(cell["limits"]) <= {
        "init_map_mismatch", "store_mismatch", "window_mismatch",
        "track_loss_gap", "track_step_gap", "map_loss_gap", "map_step_gap",
        "map_steps_gap", "map_pose_gap"}
    for m in cell["per_layer"]:
        mod = importlib.import_module(f"slambench.metrics.{m['name']}")
        assert callable(mod.read)
    conf = next(c for c in SPEC["configs"]
                if c["name"] == cell["cell"]["config"])
    assert conf["file"].startswith("slambench/configs/")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_and_a_plain_reference():
    forbidden = {"jax", "jaxlib", "flax", "myslam_tpu"}
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"),
                          recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & forbidden, path
        if os.sep + "reference" + os.sep in path:
            assert "myslam_torch" not in tops, path


def test_counts_at_a_small_shape():
    from slambench import counts

    # K1: 10 points (12 B), 5 rows of a 2-channel quad (8 f32 lanes), the
    # (10, 2 levels x 8) f32 output; 2 ops x 10 x 3 planes x 2 x 8.
    assert counts.fwd_work(10, 2, 5, 4) == (120 + 160 + 640, 960)
    # K2 with the quad gradient: gbar 640, coordinates and p_grad 240,
    # rows read and written 5 x 8 x 8; 7 ops a lane.
    assert counts.bwd_work(10, 2, 5, 4, True) == (640 + 240 + 320, 3360)
    assert counts.bwd_work(10, 2, 5, 2, False) == (640 + 240 + 80, 2400)
    # Decoder 4 -> 16 -> 16 -> 1.
    assert counts.decoder_ops(2, 1) == 2 * 4 * 16 + 2 * 16 * 16 + 2 * 16
    assert counts.bound_ms(3.35e9, 0) == (1.0, "bytes")
    # Two points in one cell and one in another, on a 3x4 plane, and all
    # three in one cell of a 2x2 plane.
    p = torch.tensor([[-1.0, -1.0, 0.0], [-0.9, -0.9, 0.0], [1.0, 1.0, 0.0]])
    assert int(counts.touched_rows(p, [(0, 1, 3, 4)])) == 2
    assert int(counts.touched_rows(p, [(0, 1, 3, 4), (2, 2, 2, 2)])) == 3
    cfg = {"model": {"c_dim": 2}, "rendering": {"n_stratified": 3,
                                                "n_importance": 1},
           "tracking": {"pixels": 5}, "mapping": {"pixels": 7}}
    assert counts.iteration_ops(cfg, "track") == 5 * 4 * counts.point_ops(
        2, "inputs")
    assert counts.iteration_ops(cfg, "map", True) == 7 * 4 * (
        counts.point_ops(2, "all")) + 7 * 3 * (
        counts.sample_ops(2) + counts.decoder_ops(2, 1)
        + counts.COMPOSITE_OPS)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_rehearsal_prints_a_line(workload):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         workload, "--seed", "2147483653", "--seconds", "1", "--trace", "1",
         "--rehearse"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-3000:]
    assert list(line)[-1] == "compared"
    assert line["device"]["platform"] == "cpu"
    per_layer = [m["name"] for m in SPEC["per_layer"]]
    assert set(line["metrics"]) == set(per_layer)
    for name in ("k1_roofline", "k2_roofline", "device_idle_pct",
                 "step_mfu", "peak_mem_gib"):
        assert line["metrics"][name]["note"] == "not measured"
    last = list(line["compared"])[-1]
    assert out.stderr.strip().splitlines()[-1].startswith(last)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         WORKLOADS[0], "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_no_program_no_result(tmp_path):
    """In a folder that holds only BENCHMARK.json and slambench/, the run
    fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload", WORKLOADS[0],
         "--seed", "1", "--seconds", "1", "--rehearse"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


def _run(workload, **kw):
    from slambench import harness

    return harness.run_cell(workload, 5, 0.5, False, rehearse=True, **kw)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_refused(workload):
    run = _run(workload, control=True)["run"]
    assert run["correct"] is False, run["compared"]


def _fault_unchanged_step(monkeypatch):
    """The mapper's step returns the map unchanged."""
    from myslam_torch.engine import mapper

    make = mapper.make_map_optimizer

    def frozen(*a, **k):
        opt = make(*a, **k)
        opt.step = lambda *aa, **kk: None
        return opt

    monkeypatch.setattr(mapper, "make_map_optimizer", frozen)


def _fault_half_batch(monkeypatch):
    """Every loss term leaves out the second half of the rays and takes
    its mean over the rest."""
    from myslam_torch.core import losses

    mean = losses.masked_mean

    def half(x, mask):
        keep = torch.arange(mask.shape[0]) < mask.shape[0] // 2
        keep = keep.reshape((-1,) + (1,) * (mask.dim() - 1))
        return mean(x, mask & keep)

    monkeypatch.setattr(losses, "masked_mean", half)


def _fault_pose_step(monkeypatch):
    """The joint optimisation's pose update takes twice its step."""
    from myslam_torch.engine import mapper

    make = mapper.make_map_optimizer

    def doubled(cfg, ms, poses, lr_factor):
        opt = make(cfg, ms, poses, lr_factor)
        if poses is not None:
            opt.param_groups[-1]["lr"] *= 2.0
        return opt

    monkeypatch.setattr(mapper, "make_map_optimizer", doubled)


def _fault_altered_answer(monkeypatch):
    """The sample's forward answers 1 % off where it is produced."""
    from myslam_torch.ops import cuda_sample

    fwd = cuda_sample.plane_sample_fwd
    monkeypatch.setattr(cuda_sample, "plane_sample_fwd",
                        lambda *a: fwd(*a) * 1.01)


@pytest.mark.parametrize("fault", [_fault_unchanged_step,
                                   _fault_half_batch,
                                   _fault_pose_step,
                                   _fault_altered_answer])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_faults_are_refused(workload, fault, monkeypatch):
    fault(monkeypatch)
    run = _run(workload)["run"]
    assert run["correct"] is False, run["compared"]


@pytest.mark.cuda
def test_cell_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         WORKLOADS[0], "--seed", "3", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
