"""The loop's bookkeeping against the JAX package's: metrics.jsonl, the
periodic checkpoints and meshes, the heartbeat and the fault hook,
``tools/eval_ate.py``'s CLI, and a supervised run killed and resumed.

The JAX side runs its own code: ``SLAMSystem._post_map``, ``_beat`` and
the loop's record keeping (``run_loop``, ``_flush_track_buf``,
``_run_track_group``, ``_log_metrics``, ``_flush_metrics``) called
unbound on a stub whose device work (tracking, mapping, checkpoint,
mesh) is replaced by recorders.  The port runs its real loop at 24x32
(tests/test_torch_mesh.py's tiny config on the packed store,
``ckpt_freq`` 4).  Tolerances: file sets, frame sequences, keys and
printed lines equal; the supervised run's trajectory and map equal to the
uninterrupted run's bit for bit (the draws' generator state is in the
checkpoint).
"""

import json
import os
import subprocess
import sys
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from myslam_torch.engine import scheduler as tsched
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
from myslam_tpu.engine import scheduler as jsched
from myslam_tpu.utils import datasets as jdata

torch.set_num_threads(2)  # several test workers share the CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J = jsched.SLAMSystem
T = tsched.SLAMSystem


def tiny_config(tmp_path, n_frames=6, **mapping) -> str:
    cfg = {
        "inherit_from": os.path.join(REPO, "configs", "Synthetic",
                                     "room.yaml"),
        "keyframe_device": "cpu",
        "verbose": True,
        "data": {"n_frames": n_frames, "output": str(tmp_path / "out")},
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5},
        "model": {"c_dim": 8},
        "planes_res": {"coarse": 0.48, "fine": 0.24},
        "c_planes_res": {"coarse": 0.48, "fine": 0.12},
        "tracking": {"pixels": 64, "iters": 4, "ignore_edge_H": 2,
                     "ignore_edge_W": 2},
        "mapping": {"pixels": 128, "iters_first": 20, "iters": 3,
                    "ckpt_freq": 4, **mapping},
        "meshing": {"resolution": 0.25},
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's uninterrupted tiny run: 6 frames, mapped 0, 4 and 5,
    a periodic checkpoint at 4, the final one at 5."""
    tmp = tmp_path_factory.mktemp("run")
    path = tiny_config(tmp)
    slam = T(load_config(path, DEFAULT_CONFIG), seed=0, device="cpu")
    slam.run()
    return path, slam


# -- the JAX package's bookkeeping on a stub -----------------------------------


class JaxLoop:
    """JAX's SLAMSystem loop and bookkeeping methods over recorders in
    place of its device programs."""

    run_loop = J.run_loop
    _flush_track_buf = J._flush_track_buf
    _run_track_group = J._run_track_group
    _track_frame = J._track_frame
    _log_metrics = J._log_metrics
    _flush_metrics = J._flush_metrics
    _beat = J._beat
    _touch_heartbeat = J._touch_heartbeat
    _post_map = J._post_map
    _make_packet = J._make_packet
    _needs_full = J._needs_full
    _maybe_track_vis = J._maybe_track_vis
    _tracking_map = J._tracking_map
    _put = J._put
    _stage_in = J._stage_in

    def __init__(self, cfg: dict, output: str):
        m = cfg["mapping"]
        self.cfg, self.output, self.seed = cfg, output, 0
        self.dataset = jdata.get_dataset(cfg)
        self.n_img = len(self.dataset)
        self.every_frame = int(m["every_frame"])
        self.ckpt_freq, self.mesh_freq = int(m["ckpt_freq"]), \
            int(m["mesh_freq"])
        self.no_log_on_first_frame = bool(m["no_log_on_first_frame"])
        self.no_mesh_on_first_frame = bool(m["no_mesh_on_first_frame"])
        self.gt_camera, self.pipeline, self.verbose = False, False, False
        self._repl, self.proc0, self.map_state = None, True, None
        self.track_vis = self.map_vis = types.SimpleNamespace(freq=10 ** 9)
        iters = int(cfg["tracking"]["iters"])

        def group(ms, est, idx0, px_i, *rest):
            g = px_i.shape[0]
            return (est, jnp.zeros((g, 4, 4)), jnp.arange(g) + 1.0,
                    jnp.arange(g) + 0.5, jnp.zeros((g, iters, 7)))

        def frame(ms, est, idx, *rest):
            return (est, jnp.zeros((4, 4)), jnp.float32(1.0),
                    jnp.float32(0.5), jnp.zeros((iters, 7)))

        self.group_tracker = group if self.every_frame > 1 else None
        self.tracker = frame
        self._track_buf, self.frame_times, self.frame_start_wall = [], [], []
        self._est_dev = jnp.zeros((self.n_img, 4, 4))
        self.gt_poses = np.zeros((self.n_img, 4, 4), np.float32)
        self.sync_after_frame = self.on_map_done = None
        self.metrics_path = os.path.join(output, "metrics.jsonl")
        os.makedirs(output, exist_ok=True)
        self._metrics_f = open(self.metrics_path, "a")
        self._pending_metrics, self.metrics_flush_every = [], 200
        self._compilelog = types.SimpleNamespace(drain=lambda: [])
        self.compile_secs = 0.0
        self.files = []

    def warmup(self):
        pass

    def _next_key(self):
        return None

    def _drain_barrier(self):
        pass

    def _map_frame(self, idx, pkt, first, cur_has_depthless):
        return self._post_map(idx, jnp.ones(3), time.time())

    def _checkpoint(self, path, idx):
        self.files.append(os.path.relpath(path, self.output))

    def _extract_and_cull_mesh(self, path, upto):
        self.files.append(os.path.relpath(path, self.output))


class PortPostMap:
    """The port's _post_map over recorders."""

    _post_map = T._post_map

    def __init__(self, jstub: JaxLoop, files: list):
        for k in ("n_img", "ckpt_freq", "mesh_freq", "no_log_on_first_frame",
                  "no_mesh_on_first_frame", "output"):
            setattr(self, k, getattr(jstub, k))
        self.verbose, self.bookkeeping, self.files = False, [], files

    def _flush_metrics(self):
        pass

    def _extract_and_cull_mesh(self, path, upto, seconds=None):
        self.files.append(os.path.relpath(path, self.output))
        seconds.update(mesh=0.0, cull=0.0)


@pytest.mark.parametrize("schedule", [
    # n_frames, every_frame, ckpt_freq, mesh_freq, no_log, no_mesh
    (13, 4, 4, 8, True, True),
    (13, 4, 4, 4, False, False),
    (9, 1, 2, 3, True, False),
    (12, 4, 500, 4000, True, True),
    (8, 1, 1, 1, False, True),
])
def test_checkpoint_and_mesh_cadence_matches_jax(tmp_path, monkeypatch,
                                                 schedule):
    n, every, ckpt, mesh, no_log, no_mesh = schedule
    cfg = load_config(tiny_config(tmp_path, n, every_frame=every,
                                  ckpt_freq=ckpt, mesh_freq=mesh,
                                  no_log_on_first_frame=no_log,
                                  no_mesh_on_first_frame=no_mesh),
                      DEFAULT_CONFIG)
    jstub = JaxLoop(cfg, str(tmp_path / "out"))
    ours = []
    port = PortPostMap(jstub, ours)
    monkeypatch.setattr(tsched, "save_checkpoint", lambda path, slam, idx:
                        ours.append(os.path.relpath(path, port.output)))
    for idx in range(n):
        if idx % every == 0 or idx == n - 1:
            J._post_map(jstub, idx, jnp.ones(3), time.time())
            port._post_map(idx)
    assert ours == jstub.files
    assert [b["frame"] for b in port.bookkeeping] == sorted(
        {int(f.split("/")[-1][:5]) for f in ours})


def test_metrics_frames_and_keys_match_jax(tmp_path, run):
    """The port's metrics.jsonl holds the frames in the JAX package's
    order, each with at least JAX's keys."""
    path, slam = run
    jstub = JaxLoop(load_config(path, DEFAULT_CONFIG), str(tmp_path / "j"))
    jstub.run_loop()
    jstub._metrics_f.close()
    with open(jstub.metrics_path) as f:
        theirs = [json.loads(ln) for ln in f]
    with open(slam.metrics_path) as f:
        ours = [json.loads(ln) for ln in f]
    assert [r["frame"] for r in ours] == [r["frame"] for r in theirs] \
        == list(range(6))
    for a, b in zip(ours, theirs):
        assert set(b) <= set(a), (a, b)
        assert all(np.isfinite(a[k]) for k in b)
    assert [r["frame"] for r in ours if "map_loss" in r] == [0, 4, 5]
    assert slam.frame_log == ours
    assert sorted(os.listdir(os.path.join(slam.output, "ckpts"))) == [
        "00004.npz", "00005.npz"]


@pytest.mark.parametrize("fault", ["3", "3:0", "3:1"])
def test_heartbeat_and_fault_hook_match_jax(tmp_path, monkeypatch, fault):
    monkeypatch.setenv("MYSLAM_FAULT_KILL", fault)

    def exit_(code):
        raise SystemExit(code)

    monkeypatch.setattr(os, "_exit", exit_)
    results = {}
    for name, beat in (("jax", J._beat), ("port", T._beat)):
        stub = types.SimpleNamespace(output=str(tmp_path / name), proc0=True)
        os.makedirs(stub.output)
        stub._touch_heartbeat = types.MethodType(
            J._touch_heartbeat if name == "jax" else T._touch_heartbeat,
            stub)
        codes = []
        for idx in range(6):
            try:
                beat(stub, idx)
            except SystemExit as e:
                codes.append((idx, e.code))
        with open(os.path.join(stub.output, "HEARTBEAT")) as f:
            hb = f.read().split()
        marker = os.path.join(stub.output, "FAULT_INJECTED")
        results[name] = (codes, hb[0], float(hb[1]) <= time.time(),
                         open(marker).read() if os.path.exists(marker)
                         else None)
    assert results["port"] == results["jax"]
    if fault == "3:1":
        assert results["port"][0] == []
    else:
        assert results["port"][0] == [(3, 21)]
        assert results["port"][3] == "3\n"


def test_eval_ate_cli_prints_what_jax_prints(run, capsys, monkeypatch):
    from myslam_torch.tools import eval_ate as t_ate
    from myslam_tpu.tools import eval_ate as j_ate

    path, slam = run
    t_ate.main([path, "--output", slam.output])
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["eval_ate", path, "--output",
                                      slam.output])
    j_ate.main()
    theirs = capsys.readouterr().out
    assert ours == theirs and "absolute_translational_error.rmse" in ours
    rmse = float(ours.split("absolute_translational_error.rmse: ")[1]
                 .split()[0])
    assert rmse == slam.ate()["absolute_translational_error.rmse"]


def test_supervised_run_killed_and_resumed_is_bit_exact(run, tmp_path):
    """run_torch.py --supervise with MYSLAM_FAULT_KILL=5: the child dies
    at frame 5, after the checkpoint of frame 4; the restart resumes
    there and ends with the uninterrupted run's trajectory and map bit
    for bit, every frame once in metrics.jsonl."""
    path, slam = run
    out = tmp_path / "sup"
    env = dict(os.environ, MYSLAM_FAULT_KILL="5", OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "run_torch.py"), path,
         "--device", "cpu", "--output", str(out), "--supervise"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert [ln for ln in lines if ln.startswith("SUPERVISOR:")] == [
        "SUPERVISOR: job died (rc=21) — restart 1/3 from the newest "
        "checkpoint", "SUPERVISOR: completed after 1 restart(s)"]
    assert f"Resumed from {out}/ckpts/00004.npz at frame 5" in lines
    result = json.loads(lines[-1])
    assert result["resumed_from"] == 5 and result["output"] == str(out)
    with np.load(out / "ckpts" / "00005.npz", allow_pickle=True) as ck:
        np.testing.assert_array_equal(ck["estimate_c2w_list"],
                                      slam.estimates)
        np.testing.assert_array_equal(
            ck["sdf_atlas"], slam.map_state.sdf_atlas.detach().numpy())
    with open(out / "metrics.jsonl") as f:
        assert [json.loads(ln)["frame"] for ln in f] == list(range(6))
    assert (out / "HEARTBEAT").exists() and (out / "FAULT_INJECTED").exists()


def test_metrics_log_a_build_record_when_the_system_built(run, monkeypatch):
    """A flush after this system compiled the kernels or the codec writes
    one ``build`` record with the seconds, once (the counterpart of the
    JAX package's compile records)."""
    from myslam_torch.utils import imageio

    _, slam = run
    with open(slam.metrics_path) as f:
        before = f.read()
    monkeypatch.setattr(imageio, "BUILD_SECONDS",
                        imageio.BUILD_SECONDS + 1.5)
    slam._flush_metrics()
    slam._flush_metrics()
    with open(slam.metrics_path) as f:
        added = f.read()[len(before):].splitlines()
    assert [json.loads(ln) for ln in added] == [
        {"phase": "build", "compile_secs": 1.5}]
    with open(slam.metrics_path, "w") as f:
        f.write(before)


def test_supervisor_kills_a_hung_job_and_gives_up(tmp_path, monkeypatch,
                                                   capsys):
    """A job whose HEARTBEAT does not change for --hang-timeout seconds
    is killed with its process group and restarted; after
    --max-restarts the supervisor returns a nonzero code."""
    import run_torch

    hang = tmp_path / "hang.py"
    hang.write_text("import time\ntime.sleep(120)\n")
    monkeypatch.setattr(run_torch, "__file__", str(hang))
    args = run_torch.parse_args(["cfg.yaml", "--output", str(tmp_path),
                                 "--supervise", "--hang-timeout", "1",
                                 "--max-restarts", "1"])
    t0 = time.time()
    assert run_torch.supervise(args) != 0
    assert time.time() - t0 < 30
    lines = capsys.readouterr().out.splitlines()
    assert lines == [
        "SUPERVISOR: no heartbeat for 1s — killing the job",
        "SUPERVISOR: job hung — restart 1/1 from the newest checkpoint",
        "SUPERVISOR: no heartbeat for 1s — killing the job",
        "SUPERVISOR: giving up after 1 restart(s) (rc=-9)"]
