"""The port's entry points and its package rules.

  * ``run_torch.py --device cpu`` completes a tiny synthetic run, reports
    a finite ATE and writes the final mesh and its culled copy;
  * ``SLAMSystem`` defaults to the GPU and refuses to run without one;
  * no module of ``myslam_torch/``, nor ``chip_smoke.py``,
    ``run_torch.py`` or ``bench_torch.py``, imports JAX, the JAX package,
    OpenCV or Pillow (checked on the sources' import statements): the
    card's machine has neither image library, so the port reads its
    images with its own codec.
"""

import ast
import math
import os

import pytest
import torch
import yaml

torch.set_num_threads(2)  # several test workers share the CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "myslam_tpu", "cv2", "PIL")


def _port_sources():
    paths = [os.path.join(REPO, name) for name in
             ("chip_smoke.py", "run_torch.py", "bench_torch.py")]
    for root, _, files in os.walk(os.path.join(REPO, "myslam_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_port_never_imports_jax_or_the_jax_package():
    """Nor OpenCV or Pillow."""
    sources = _port_sources()
    assert len(sources) > 20
    bad = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def _tiny_config(tmp_path):
    cfg = {
        "inherit_from": os.path.join(REPO, "configs", "Synthetic",
                                     "room.yaml"),
        "data": {"n_frames": 6, "output": str(tmp_path / "out")},
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5},
        "model": {"c_dim": 8},
        "planes_res": {"coarse": 0.48, "fine": 0.24},
        "c_planes_res": {"coarse": 0.48, "fine": 0.12},
        "tracking": {"pixels": 64, "iters": 4, "ignore_edge_H": 2,
                     "ignore_edge_W": 2},
        "mapping": {"pixels": 128, "iters_first": 20, "iters": 3},
        # Coarse: room.yaml's 1 cm grid is 47 M points.
        "meshing": {"resolution": 0.25},
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_run_torch_on_cpu_reports_finite_ate(tmp_path, capsys):
    import run_torch

    out = run_torch.main([_tiny_config(tmp_path), "--device", "cpu",
                          "--seed", "1"])
    assert out["device"] == "cpu" and out["frames"] == 6
    assert math.isfinite(out["ate_rmse_cm"])
    assert out["final_mesh"] == str(
        tmp_path / "out" / "mesh" / "final_mesh_culled.ply")
    assert os.path.exists(tmp_path / "out" / "mesh" / "final_mesh.ply")
    assert capsys.readouterr().out.strip().endswith("}")


def test_slam_system_defaults_to_the_gpu(monkeypatch):
    import myslam_torch
    from myslam_torch.engine.scheduler import SLAMSystem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        myslam_torch.default_device()
    with pytest.raises(RuntimeError):
        SLAMSystem({"cam": {}})
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
