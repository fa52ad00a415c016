"""The port's mesh culling and reconstruction metrics against the JAX
package, on the CPU.

  * ``vertex_visibility`` (frustum, and eval_rec's occlusion test) on the
    vertices of the synthetic room's GT mesh over 20 frames: masks
    identical except vertices within 1e-5 of a mask boundary (counted and
    reported); independent of the frames per step; ``cull_mesh``'s file;
  * ``calc_3d_metric``: identical on the same files and seed;
  * the depth rasterizer on an analytic sphere: the same coverage and
    depths within 1e-5 relative.  Two float32 evaluations of its
    formula differ by more than 1e-6: the barycentrics divide edge
    functions of ~100-pixel coordinates, which amplifies the last ulp,
    and XLA's CPU code fuses multiply-adds where PyTorch's operations
    round each product (measured: 2.2e-6 at 5 of 1,834 pixels here, and
    1.2e-6 with the camera at the identity, where no rotation is summed);
  * ``calc_2d_metric`` at 5 views (the same seeded numpy views, with an
    unseen point set to reject against): within 1e-4 relative.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myslam_tpu.ops import marching as jmarch
from myslam_tpu.tools import cull_mesh as jcull
from myslam_tpu.tools import eval_recon as jeval
from myslam_tpu.utils import meshmath as jmm
from myslam_torch.tools import cull_mesh, eval_recon
from myslam_torch.utils import meshmath, ply
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
from myslam_torch.utils.datasets import Prefetcher, get_dataset

torch.set_num_threads(2)  # several test workers share the CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def room_cfg(eval_rec):
    cfg = load_config(os.path.join(REPO, "configs", "Synthetic",
                                   "room.yaml"), DEFAULT_CONFIG)
    cfg["cam"].update(H=48, W=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5)
    cfg["data"]["n_frames"] = 20
    cfg["meshing"]["eval_rec"] = eval_rec
    return cfg


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """The room's GT mesh at 0.08 m and the 48x64 frames of 20 poses."""
    cfg = room_cfg(True)
    ds = get_dataset(cfg)
    path = str(tmp_path_factory.mktemp("room") / "gt.ply")
    ds.save_gt_mesh(path, resolution=0.08, device="cpu")
    frames = [(d, p) for _, (c, d, p) in Prefetcher(ds, range(len(ds)))]
    return path, frames


def near_boundary(verts, cfg, frames, tol=1e-5):
    """Vertices within ``tol`` (pixels, meters) of one of the mask's
    boundaries in some frame, in float64."""
    cam = cfg["cam"]
    H, W = cam["H"], cam["W"]
    near = np.zeros(len(verts), bool)
    v64 = verts.astype(np.float64)
    for depth, c2w in frames:
        w2c = np.linalg.inv(c2w.astype(np.float64))
        p = v64 @ w2c[:3, :3].T + w2c[:3, 3]
        z = p[:, 2]
        zs = z + 1e-5
        u = (cam["fx"] * -p[:, 0] + cam["cx"] * z) / zs
        v = (cam["fy"] * p[:, 1] + cam["cy"] * z) / zs
        ds = jcull._bilinear_zeros(
            jnp.asarray(depth), jnp.asarray(u * (depth.shape[1] - 1) / W,
                                            jnp.float32),
            jnp.asarray(v * (depth.shape[0] - 1) / H, jnp.float32))
        margins = [z, u, W - u, v, H - v]
        if cfg["meshing"]["eval_rec"]:
            margins.append(np.asarray(ds) + cfg["model"]["truncation"] + z)
        near |= np.min(np.abs(np.stack(margins)), axis=0) < tol
    return near


@pytest.mark.parametrize("eval_rec", [False, True])
def test_vertex_visibility_matches_jax(room, eval_rec):
    path, frames = room
    cfg = room_cfg(eval_rec)
    verts, faces, _ = ply.read_ply(path)
    est = np.stack([p for _, p in frames])
    est[:, :3, 3] += 0.01  # estimated poses stand in for the frames'
    got = cull_mesh.vertex_visibility(verts, cfg, iter(frames), est,
                                      device="cpu")
    ref = jcull.vertex_visibility(verts, cfg, iter(frames), est)
    assert got.dtype == bool and 0.05 < got.mean() < 0.95
    near = near_boundary(verts, cfg, [(d, p) for (d, _), p in
                                      zip(frames, est)])
    differ = got != ref
    print(f"visibility eval_rec={eval_rec}: {len(verts)} vertices, "
          f"{int(near.sum())} within 1e-5 of a mask boundary, "
          f"{int(differ.sum())} differ")
    assert not (differ & ~near).any()
    # The frames per step do not change the result.
    np.testing.assert_array_equal(
        got, cull_mesh.vertex_visibility(verts, cfg, iter(frames), est,
                                         frames_per_program=3,
                                         device="cpu"))


def test_cull_mesh_matches_jax(room, tmp_path):
    path, frames = room
    cfg = room_cfg(True)
    out = cull_mesh.cull_mesh(path, cfg, iter(frames),
                              str(tmp_path / "t.ply"), device="cpu")
    jout = jcull.cull_mesh(path, cfg, iter(frames), str(tmp_path / "j.ply"))
    v, f, _ = ply.read_ply(out)
    jv, jf, _ = ply.read_ply(jout)
    assert 0 < len(f) < len(ply.read_ply(path)[1])
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


def test_calc_3d_metric_matches_jax(room, tmp_path):
    path, _ = room
    v, f, _ = ply.read_ply(path)
    rng = np.random.default_rng(5)
    c, s = np.cos(0.02), np.sin(0.02)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    rec = v @ R.T + 0.01 + rng.normal(scale=0.005, size=v.shape)
    rec_path = str(tmp_path / "rec.ply")
    ply.write_ply(rec_path, rec.astype(np.float32), f[: len(f) * 3 // 4])
    for align in (True, False):
        got = eval_recon.calc_3d_metric(rec_path, path, align=align,
                                        num_points=20_000, seed=2)
        ref = jeval.calc_3d_metric(rec_path, path, align=align,
                                   num_points=20_000, seed=2)
        assert got == ref
        assert 0 < got["accuracy_cm"] < 10 and 0 < got["completion_cm"]


def sphere_mesh(r=0.6, n=40):
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    return jmarch.extract_isosurface(np.linalg.norm(g, axis=-1) - r,
                                     [-1, -1, -1], [xs[1] - xs[0]] * 3)


def test_rasterizer_matches_jax():
    v, f = sphere_mesh()
    v, f = meshmath.subdivide_to_edge(v, f, 0.03)
    H, W, fx, cx = 96, 128, 90.0, 63.5
    c2w = eval_recon._viewmatrix(np.array([0.3, -0.2, 1.0]),
                                 np.array([0.0, 1.0, 0.0]),
                                 np.array([-0.6, 0.4, -2.2]))
    w2c = np.linalg.inv(c2w)
    got = meshmath.make_depth_rasterizer(H, W, fx, fx, cx, 47.5,
                                         device="cpu")(v[f], w2c)
    ref = jmm.make_depth_rasterizer(H, W, fx, fx, cx, 47.5)(v[f], w2c)
    cover = ref > 0
    assert 0.1 < cover.mean() < 0.9
    np.testing.assert_array_equal(got > 0, cover)
    np.testing.assert_allclose(got[cover], ref[cover], rtol=1e-5, atol=0)
    # The sphere's near side: its depth lies between the center's
    # distance less the radius and the center's distance.
    dist = np.linalg.norm(c2w[:3, 3])
    assert got[cover].min() > dist - 0.61 and got[cover].max() < dist


def test_calc_2d_metric_matches_jax(tmp_path):
    v, f = sphere_mesh()
    gt = str(tmp_path / "gt.ply")
    ply.write_ply(gt, v, f)
    rng = np.random.default_rng(3)
    rec = str(tmp_path / "rec.ply")
    ply.write_ply(rec, (v * 1.02 + rng.normal(scale=0.003, size=v.shape))
                  .astype(np.float32), f)
    # An unseen set: the views that would see it are rejected.
    np.save(str(tmp_path / "gt_pc_unseen.npy"), v[v[:, 2] > 0.55])
    got = eval_recon.calc_2d_metric(rec, gt, n_imgs=5, device="cpu")
    ref = jeval.calc_2d_metric(rec, gt, n_imgs=5)
    assert 0.5 < got["depth_l1_cm"] < 5
    assert abs(got["depth_l1_cm"] - ref["depth_l1_cm"]) <= \
        1e-4 * abs(ref["depth_l1_cm"])


@pytest.mark.parametrize("entry", ["hull", "rasterizer", "marching",
                                   "visibility"])
def test_meshing_entry_points_default_to_the_gpu(entry, monkeypatch):
    """With no device given, each runs on the GPU, and raises when none
    is visible, rather than working on the host."""
    from myslam_torch.ops.marching import extract_isosurface
    from myslam_torch.utils.mesher import HullBound

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cube = np.array([[a, b, c] for a in (0, 1) for b in (0, 1)
                     for c in (0, 1)], np.float64)
    call = {
        "hull": lambda: HullBound(cube),
        "rasterizer": lambda: meshmath.make_depth_rasterizer(
            8, 8, 4.0, 4.0, 3.5, 3.5),
        "marching": lambda: extract_isosurface(
            np.ones((4, 4, 4), np.float32), [0, 0, 0], [1, 1, 1]),
        "visibility": lambda: cull_mesh.vertex_visibility(
            cube, room_cfg(False), []),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
