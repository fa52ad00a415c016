"""The port's entry points and its package rules.

  * ``run_torch.py --device cpu`` completes a tiny synthetic run, reports
    a finite ATE and writes the final mesh and its culled copy;
  * ``SLAMSystem`` defaults to the GPU and refuses to run without one;
  * no module of ``myslam_torch/`` (``parallel/`` included, and the
    tests' gang harness ``tests/torch_gang.py``), nor ``chip_smoke.py``,
    ``run_torch.py``, ``bench_torch.py`` or ``visualizer_torch.py``,
    imports JAX, the JAX package, OpenCV, Pillow, matplotlib or open3d
    (checked on the sources' import statements): the port reads and
    writes its images with its own codec and draws in numpy.  The only
    exception: ``utils/frontend.py``'s open3d and matplotlib backends
    import their library inside the backend's function.
"""

import ast
import math
import os

import pytest
import torch
import yaml

torch.set_num_threads(2)  # several test workers share the CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "myslam_tpu", "cv2", "PIL",
             "matplotlib", "open3d")
# The interactive backends' lazy imports: (file, function, module).
LAZY_BACKENDS = {("myslam_torch/utils/frontend.py", "_open3d_loop", "open3d"),
                 ("myslam_torch/utils/frontend.py", "_matplotlib_loop",
                  "matplotlib")}


def _port_sources():
    paths = [os.path.join(REPO, name) for name in
             ("chip_smoke.py", "run_torch.py", "bench_torch.py",
              "visualizer_torch.py")]
    for root, _, files in os.walk(os.path.join(REPO, "myslam_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imports(tree):
    """(enclosing function or None, imported module) of every import."""
    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name if fn is None else fn)
                continue
            if isinstance(child, ast.Import):
                out.extend((fn, a.name) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                out.append((fn, child.module or ""))
            visit(child, fn)

    visit(tree, None)
    return out


def test_port_never_imports_jax_or_the_jax_package():
    """Nor OpenCV, Pillow, matplotlib or open3d, but in the frontend's
    two interactive backends."""
    sources = _port_sources()
    assert len(sources) > 20
    bad, lazy = [], set()
    for path in sources:
        rel = os.path.relpath(path, REPO)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for fn, name in _imports(tree):
            top = name.split(".")[0]
            if top not in FORBIDDEN:
                continue
            if (rel, fn, top) in LAZY_BACKENDS:
                lazy.add((rel, fn, top))
            else:
                bad.append(f"{rel}: {name} (in {fn or 'the module'})")
    assert not bad, bad
    assert lazy == LAZY_BACKENDS


def test_the_gang_imports_no_jax():
    """The multi-process modules (myslam_torch/parallel/) are among the
    checked sources and import none of FORBIDDEN; nor does the tests'
    gang harness, whose ranks run without JAX."""
    parallel = sorted(
        os.path.join(REPO, "myslam_torch", "parallel", f) for f in
        ("__init__.py", "distributed.py", "distributed_ba.py",
         "multiproc.py"))
    assert set(parallel) <= set(_port_sources())
    for path in parallel + [os.path.join(REPO, "tests", "torch_gang.py")]:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        names = [name for _, name in _imports(tree)]
        assert not [n for n in names
                    if n.split(".")[0] in FORBIDDEN], path


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
