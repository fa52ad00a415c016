"""The gang across processes on CPU ranks over gloo: ``run_torch.py
--launch`` (``myslam_torch/parallel/multiproc.py``) and its supervision.

  * ``run_torch.py --launch 2 --device cpu`` on a 24x32 room: one JSON
    line, from rank 0, the other rank's start line, metrics once per
    frame;
  * ``--supervise --launch 2`` with rank 1 killed at frame 5: the whole
    gang restarts once from rank 0's checkpoint of frame 4 and ends with
    the uninterrupted gang's trajectory and map, bit for bit;
  * ``run_product`` with a folder per rank: only rank 0's holds the
    checkpoint, and both ranks resume from it;
  * the gang's loops run on the GPU unless the CPU is asked for, and
    raise without one.

The mini-loop against the JAX package's is test_torch_minislam.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from myslam_torch.parallel import multiproc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2


def gang_config(tmp_path, n_frames=6) -> str:
    """The synthetic room at 24x32 under ray DP over every rank: mapped
    frames 0, 4 and 5, a checkpoint at 4."""
    cfg = {
        "inherit_from": os.path.join(REPO, "configs", "Synthetic",
                                     "room.yaml"),
        "keyframe_device": "cpu",
        "verbose": True,
        "data": {"n_frames": n_frames},
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5},
        "model": {"c_dim": 8},
        "planes_res": {"coarse": 0.48, "fine": 0.24},
        "c_planes_res": {"coarse": 0.48, "fine": 0.12},
        "tracking": {"pixels": 64, "iters": 4, "ignore_edge_H": 2,
                     "ignore_edge_W": 2},
        "mapping": {"pixels": 128, "iters_first": 20, "iters": 3,
                    "ckpt_freq": 4},
        "meshing": {"resolution": 0.25},
        "parallel": {"devices": 0},
    }
    path = tmp_path / "gang.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def run_gang(config, out, *extra, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "run_torch.py"), config,
         "--device", "cpu", "--output", str(out), "--launch", str(RANKS),
         *extra], env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})),
        capture_output=True, text=True, timeout=300, cwd=REPO)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """run_torch.py --launch 2 --device cpu, uninterrupted."""
    tmp = tmp_path_factory.mktemp("gang")
    config = gang_config(tmp)
    out = tmp / "out"
    proc = run_gang(config, out)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return config, out, proc.stdout.splitlines()


def test_launch_runs_the_gang_and_rank0_reports(gang):
    """One JSON line, rank 0's, last; rank 1 says where it started;
    metrics.jsonl holds every frame once; the final checkpoint holds the
    trajectory the JSON line scores."""
    _, out, lines = gang
    assert "RANK 1: resumed_from 0" in lines
    results = [ln for ln in lines if ln.startswith("{")]
    assert len(results) == 1 and lines[-1] == results[0]
    result = json.loads(results[0])
    assert result["resumed_from"] == 0 and result["output"] == str(out)
    assert np.isfinite(result["ate_rmse_cm"])
    with open(out / "metrics.jsonl") as f:
        assert [json.loads(ln)["frame"] for ln in f] == list(range(6))
    with np.load(out / "ckpts" / "00005.npz", allow_pickle=True) as ck:
        est = ck["estimate_c2w_list"]
    assert np.isfinite(est).all() and est.shape == (6, 4, 4)


def test_supervised_gang_killed_and_resumed_is_bit_exact(gang, tmp_path):
    """--supervise --launch 2 with MYSLAM_FAULT_KILL=5:1: rank 1 dies at
    frame 5, the launcher kills rank 0, the supervisor restarts the gang
    once from rank 0's checkpoint of frame 4, both ranks start at 5, and
    the run ends with the uninterrupted gang's trajectory and map bit
    for bit."""
    config, ref_out, _ = gang
    out = tmp_path / "sup"
    proc = run_gang(config, out, "--supervise",
                    env={"MYSLAM_FAULT_KILL": "5:1"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert [ln for ln in lines if ln.startswith("SUPERVISOR:")] == [
        "SUPERVISOR: job died (rc=21) — restart 1/3 from the newest "
        "checkpoint", "SUPERVISOR: completed after 1 restart(s)"]
    assert "RANK 1: resumed_from 5" in lines
    assert f"Resumed from {out}/ckpts/00004.npz at frame 5" in lines
    assert json.loads(lines[-1])["resumed_from"] == 5
    with np.load(out / "ckpts" / "00005.npz", allow_pickle=True) as got, \
            np.load(ref_out / "ckpts" / "00005.npz",
                    allow_pickle=True) as ref:
        for k in ("estimate_c2w_list", "sdf_atlas", "color_atlas",
                  "kf_colors_u8", "kf_depths_u16"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with open(out / "metrics.jsonl") as f:
        assert [json.loads(ln)["frame"] for ln in f] == list(range(6))
    assert (out / "FAULT_INJECTED").read_text() == "5\n"


def test_rank0_decides_the_resume(monkeypatch):
    """run_product under keyframe sharding with a folder per rank: only
    rank 0's holds the final checkpoint; a fresh system on each rank
    resumes from the path rank 0 broadcasts, and restores the state bit
    for bit, each rank its own keyframe slots."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' threads
    outs = multiproc.launch(RANKS, mode="kf", frames=6, loop="product",
                            size=(24, 32), timeout=240, device="cpu")
    for out in outs:
        assert out["resume_ok"] == 1.0 and out["resumed_from"] == 6
        np.testing.assert_array_equal(out["est"], outs[0]["est"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no GPU")
@pytest.mark.parametrize("loop", ["mini", "product", "system"])
def test_gang_loops_default_to_the_gpu(tmp_path, loop):
    """run_minislam, run_product and run_system without ``device`` ask
    for the rank's GPU (``distributed.rank_device``) and raise where
    there is none, instead of running on the CPU."""
    call = {"mini": lambda: multiproc.run_minislam("dp", frames=2),
            "product": lambda: multiproc.run_product("dp", frames=2),
            "system": lambda: multiproc.run_system(
                gang_config(tmp_path, 2))}[loop]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
