"""The port's meshing (ROADMAP A11) against the JAX package, on the CPU.

Each part gets the same numpy inputs in both packages:

  * PLY: byte-identical files;
  * marching: the sphere volume of tests/test_marching.py at n = 24 and
    40 and a random signed volume from a seed: equal vertex and triangle
    counts, vertices within 1e-5 grid units in the same order, identical
    face sets (each face rotated so its smallest id leads, then sorted);
    an empty volume; a tiny ``slab_cells`` against the default;
  * the hull: votes equal as integers, the same A, b and containment;
  * the SDF volume of ``Mesher.eval_sdf_volume`` (a map carried across
    by ``models/convert.py::from_jax_numpy``, a grid of at most 40^3)
    within atol 1e-5; vertex colors within 1 in uint8;
  * the slice: ``SLAMSystem.finalize()`` on the tiny config of
    tests/test_torch_entry.py (meshed at 0.25 m) against JAX's
    ``Mesher.get_mesh`` on the same map and store: the volumes, marching
    on JAX's volume, and the two meshes within 1 % of the resolution
    by ``calc_3d_metric``.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from myslam_tpu.engine.camera import Camera as JCamera
from myslam_tpu.models.decoders import init_decoder_params
from myslam_tpu.models.planes import MapState as JMapState
from myslam_tpu.models.planes import init_map_state as j_init_map_state
from myslam_tpu.models.planes import make_layout as j_make_layout
from myslam_tpu.ops import marching as jmarch
from myslam_tpu.render import renderer as jrend
from myslam_tpu.tools import eval_recon as jeval
from myslam_tpu.utils import mesher as jmesher
from myslam_tpu.utils import ply as jply
from myslam_torch.engine.camera import Camera
from myslam_torch.engine.keyframes import KeyframeStore
from myslam_torch.models.convert import from_jax_numpy, to_jax_numpy
from myslam_torch.models.planes import compute_bound, make_layout
from myslam_torch.ops import marching
from myslam_torch.render import renderer as trend
from myslam_torch.tools import eval_recon
from myslam_torch.utils import mesher, ply
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
from myslam_torch.utils.datasets import get_dataset

torch.set_num_threads(2)  # several test workers share the CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sphere_volume(n, r=0.6):
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    return np.linalg.norm(g, axis=-1) - r


def random_volume(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(14, 11, 17)).astype(np.float32)


def canon_faces(faces):
    """Each face rotated so its smallest id leads (orientation kept),
    then the faces sorted."""
    faces = np.asarray(faces)
    k = np.argmin(faces, axis=1)
    idx = (k[:, None] + np.arange(3)[None]) % 3
    rot = np.take_along_axis(faces, idx, axis=1)
    return rot[np.lexsort(rot.T[::-1])]


def jax_extract(vol, **kw):
    v, f, nv, nt = jmarch.extract_isosurface_device(vol, **kw)
    return np.asarray(v)[:nv], np.asarray(f)[:nt]


def assert_same_mesh(v, f, jv, jf, atol=1e-5):
    assert v.shape == jv.shape and f.shape == jf.shape
    np.testing.assert_allclose(v, jv, atol=atol, rtol=0)
    np.testing.assert_array_equal(canon_faces(f), canon_faces(jf))


@pytest.mark.parametrize("colors", ["none", "float", "uint8"])
def test_ply_files_are_byte_identical(tmp_path, colors):
    verts, faces = jmarch.extract_isosurface(
        sphere_volume(24), [-1, -1, -1], [2 / 23] * 3)
    rng = np.random.default_rng(0)
    c = {"none": None,
         "float": rng.uniform(size=(len(verts), 3)),
         "uint8": rng.integers(0, 256, (len(verts), 3)).astype(np.uint8)
         }[colors]
    ply.write_ply(str(tmp_path / "t.ply"), verts, faces, c)
    jply.write_ply(str(tmp_path / "j.ply"), verts, faces, c)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    got, ref = ply.read_ply(str(tmp_path / "j.ply")), \
        jply.read_ply(str(tmp_path / "j.ply"))
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["sphere24", "sphere40", "random0",
                                  "random1"])
def test_marching_matches_jax(case):
    vol = (sphere_volume(int(case[6:])) if case.startswith("sphere")
           else random_volume(int(case[6:])))
    v, f = marching.extract_isosurface_device(torch.tensor(vol))
    jv, jf = jax_extract(vol)
    assert len(jf) > 1000
    assert_same_mesh(v.numpy(), f.numpy(), jv, jf)
    # Vertex ids follow ascending edge key, as JAX's do; faces come in
    # the same order too.
    np.testing.assert_array_equal(f.numpy(), jf)
    # World coordinates through the numpy entry.
    wv, wf = marching.extract_isosurface(vol, [-1, -1, -1], [0.1] * 3,
                                         device="cpu")
    jwv, jwf = jmarch.extract_isosurface(vol, [-1, -1, -1], [0.1] * 3)
    assert wf.dtype == jwf.dtype == np.int32
    np.testing.assert_allclose(wv, jwv, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(wf, jwf)


@pytest.mark.parametrize("case", ["sphere40", "random0"])
def test_marching_tiny_slabs_match_default(case):
    vol = torch.tensor(sphere_volume(40) if case == "sphere40"
                       else random_volume(0))
    ny, nz = vol.shape[1:]
    v1, f1 = marching.extract_isosurface_device(
        vol, slab_cells=2 * (ny - 1) * (nz - 1))
    v2, f2 = marching.extract_isosurface_device(vol)
    assert marching.slab_x_cells(vol.shape, 2 * (ny - 1) * (nz - 1)) == 2
    assert_same_mesh(v1.numpy(), f1.numpy(), v2.numpy(), f2.numpy())
    # Against JAX's single-slab extraction: JAX's own thin slabs pad x by
    # repeating the last layer, which adds triangles wherever a surface
    # reaches that layer (ROADMAP section C); the port's last slab is
    # thinner instead.
    jv, jf = jax_extract(vol.numpy())
    assert_same_mesh(v1.numpy(), f1.numpy(), jv, jf)


def test_marching_empty_volume():
    v, f = marching.extract_isosurface_device(torch.ones((8, 8, 8)))
    assert v.shape == (0, 3) and f.shape == (0, 3)
    jv, jf = jmarch.extract_isosurface(np.ones((8, 8, 8), np.float32),
                                       [0, 0, 0], [1, 1, 1])
    assert len(jv) == len(jf) == 0


# -- the mesher --------------------------------------------------------------


def small_cfg(resolution=0.12):
    cfg = load_config(os.path.join(REPO, "configs", "Synthetic",
                                   "room.yaml"), DEFAULT_CONFIG)
    cfg["cam"].update(H=48, W=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5)
    cfg["model"]["c_dim"] = 8
    cfg["planes_res"].update(coarse=0.48, fine=0.24)
    cfg["c_planes_res"].update(coarse=0.48, fine=0.12)
    cfg["meshing"]["resolution"] = resolution
    cfg["data"]["n_frames"] = 40
    return cfg


def scenes(cfg):
    """SceneGeometry of both packages for cfg."""
    bound = compute_bound(cfg)
    c = cfg["model"]["c_dim"]
    pres, cres = cfg["planes_res"], cfg["c_planes_res"]
    r = cfg["rendering"]
    common = dict(
        bound=tuple(map(tuple, bound.tolist())),
        truncation=float(cfg["model"]["truncation"]),
        n_stratified=int(r["n_stratified"]),
        n_importance=int(r["n_importance"]), perturb=bool(r["perturb"]),
        color_topk=int(r["color_topk"]))
    jb = jnp.asarray(bound)
    jscene = jrend.SceneGeometry(
        sdf_layout=j_make_layout(jb, [pres["coarse"], pres["fine"]], c),
        color_layout=j_make_layout(jb, [cres["coarse"], cres["fine"]], c),
        **common)
    scene = trend.SceneGeometry(
        sdf_layout=make_layout(bound, [pres["coarse"], pres["fine"]], c),
        color_layout=make_layout(bound, [cres["coarse"], cres["fine"]], c),
        **common)
    return jscene, scene


def stores(cfg, frames=(0, 13, 26, 39), capacity=6):
    """The same keyframes (rendered depths, GT poses) in a port
    KeyframeStore and in a JAX-store stand-in (est_c2w, depths_float(),
    count)."""
    cam = Camera.from_cfg(cfg)
    ds = get_dataset(cfg)
    store = KeyframeStore(capacity, cam, "cpu")
    depths = np.zeros((capacity, cam.H, cam.W), np.float32)
    est = np.tile(np.eye(4, dtype=np.float32), (capacity, 1, 1))
    for slot, idx in enumerate(frames):
        _, depth, c2w = ds.get_frame(idx)
        depths[slot], est[slot] = depth, c2w
    store.depths.copy_(torch.tensor(depths))
    store.est_c2w.copy_(torch.tensor(est))
    store.count = len(frames)
    jstore = types.SimpleNamespace(
        est_c2w=jnp.asarray(est), count=len(frames),
        depths_float=lambda: jnp.asarray(depths))
    return store, jstore


def test_hull_matches_jax():
    """Votes on a grid offset by 3 cm from the default one: the room's
    walls (0, 4, 3 and 2.5 m) lie exactly on the default grid's voxel
    faces (bound - 0.3 m, 0.1 m voxels), where the last ulp of a wall
    sample's back-projection picks its voxel, and XLA's CPU einsum fuses
    the rotation's multiply-adds where PyTorch's matmul does not (at
    stride 2, 94 of 82,992 default-grid voxels differ by 1-2 votes).
    The hull itself is held at the meshing defaults."""
    cfg = small_cfg()
    jscene, scene = scenes(cfg)
    cam, jcam = Camera.from_cfg(cfg), JCamera.from_cfg(cfg)
    store, jstore = stores(cfg)
    bound = np.asarray(scene.bound, np.float32)
    lo = bound[:, 0] - 0.33
    dims = tuple(int(np.ceil((bound[a, 1] + 0.33 - lo[a]) / 0.1))
                 for a in range(3))
    votes = mesher.voxel_votes(
        store.est_c2w, store.depths, store.count, cam, 2,
        torch.tensor(lo), float(np.float32(10.0)), dims)
    jvotes = jmesher._voxel_votes(
        jstore.est_c2w, jstore.depths_float(), jnp.int32(jstore.count),
        jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.H, jcam.W, 2,
        jnp.asarray(lo), jnp.float32(10.0), dims)
    assert votes.dtype == torch.int32 and int(votes.sum()) == 4 * 24 * 32
    np.testing.assert_array_equal(votes.numpy(), np.asarray(jvotes))

    pts = mesher.hull_points_device(store, cam, bound)
    jpts = jmesher.hull_points_device(jstore, jcam, jscene.bound_array)
    np.testing.assert_array_equal(pts, jpts)
    hull = mesher.HullBound(pts, 1.02, device="cpu")
    jhull = jmesher.HullBound(jpts, 1.02)
    n = hull.A.shape[0]
    # JAX pads the half-spaces to 256 with the last one repeated.
    np.testing.assert_array_equal(np.asarray(jhull.A)[:n], hull.A.numpy())
    np.testing.assert_array_equal(np.asarray(jhull.b)[:n], hull.b.numpy())
    np.testing.assert_array_equal(np.asarray(jhull.A)[n:],
                                  np.repeat(hull.A.numpy()[-1:], 256 - n, 0))
    q = np.random.default_rng(1).uniform(
        bound[:, 0] - 0.5, bound[:, 1] + 0.5, (20_000, 3)).astype(np.float32)
    inside = hull.contains(torch.tensor(q)).numpy()
    assert 0.03 < inside.mean() < 0.5
    np.testing.assert_array_equal(inside,
                                  np.asarray(jhull.contains(jnp.asarray(q))))


def pair_meshers(cfg, points_batch_size):
    jscene, scene = scenes(cfg)
    # Features of std 0.5 (not 0.01) give the fields some structure.
    jms = j_init_map_state(
        jax.random.PRNGKey(3), jscene.sdf_layout, jscene.color_layout,
        init_decoder_params(jax.random.PRNGKey(2), c_dim=8), std=0.5)
    ms = from_jax_numpy(jax.tree_util.tree_map(np.array, jms))
    m = mesher.Mesher(cfg, scene, Camera.from_cfg(cfg),
                      points_batch_size=points_batch_size)
    jm = jmesher.Mesher(cfg, jscene, JCamera.from_cfg(cfg),
                        points_batch_size=points_batch_size)
    return m, jm, ms, jms


@pytest.mark.parametrize("with_hull", [False, True])
def test_sdf_volume_matches_jax(with_hull):
    cfg = small_cfg()
    m, jm, ms, jms = pair_meshers(cfg, points_batch_size=2_000)
    hull = jhull = None
    if with_hull:
        store, _ = stores(cfg)
        pts = mesher.hull_points_device(
            store, m.cam, np.asarray(m.scene.bound, np.float32))
        hull = mesher.HullBound(pts, device="cpu")
        jhull = jmesher.HullBound(pts)
    vol, axes = m.eval_sdf_volume(ms, hull)
    jvol, jaxes = jm.eval_sdf_volume(jms, jhull)
    assert vol.shape == (38, 29, 25) and max(vol.shape) <= 40
    assert len(m.volume_chunks()) == 19  # 2 x-rows of 725 points each
    for a, b in zip(axes, jaxes):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(vol.numpy(), np.asarray(jvol), atol=1e-5,
                               rtol=0)
    # The grid reaches 5 cm past the bound; the hull of 4 views leaves
    # most of the room out.
    outside = float((vol == -1.0).float().mean())
    assert (0.5 < outside < 0.95) if with_hull else (0.05 < outside < 0.2)
    assert float(vol.std()) > 0.1


def test_vertex_colors_match_jax():
    cfg = small_cfg()
    m, jm, ms, jms = pair_meshers(cfg, points_batch_size=3_000)
    bound = np.asarray(m.scene.bound, np.float32)
    verts = np.random.default_rng(4).uniform(
        bound[:, 0], bound[:, 1], (7_000, 3)).astype(np.float32)
    got = m.vertex_colors_u8_device(ms, torch.tensor(verts)).numpy()
    ref = np.asarray(jm.vertex_colors_u8_device(jms, jnp.asarray(verts)))
    assert got.dtype == ref.dtype == np.uint8 and got.shape == (7_000, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert len(np.unique(got.reshape(-1))) > 20


# -- the slice ---------------------------------------------------------------


def tiny_config(tmp_path):
    """tests/test_torch_entry.py's tiny config, meshed at 0.25 m."""
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
        "meshing": {"resolution": 0.25},
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return load_config(str(path), DEFAULT_CONFIG)


def test_finalize_meshes_as_jax_does(tmp_path):
    from myslam_torch.engine.scheduler import SLAMSystem

    cfg = tiny_config(tmp_path)
    slam = SLAMSystem(cfg, seed=1, device="cpu")
    slam.run()
    mesh_dir = tmp_path / "out" / "mesh"
    assert slam.final_mesh == str(mesh_dir / "final_mesh_culled.ply")
    v, f, c = ply.read_ply(str(mesh_dir / "final_mesh.ply"))
    cv, cf, _ = ply.read_ply(slam.final_mesh)
    assert len(f) > 100 and c is not None and c.shape == v.shape
    assert 0 < len(cf) < len(f) and f.max() < len(v)
    assert os.path.exists(tmp_path / "out" / "ckpts" / "00005.npz")
    assert set(slam.mesher.stages) == {"hull", "sdf_volume", "marching",
                                       "vertex_colors", "fetch",
                                       "write_ply"}

    # JAX's mesher on the same map and store.
    jscene, scene = scenes(cfg)
    ms = to_jax_numpy(slam.map_state)
    jms = JMapState(sdf_atlas=jnp.asarray(ms["sdf_atlas"]),
                    color_atlas=jnp.asarray(ms["color_atlas"]),
                    decoder=jax.tree_util.tree_map(jnp.asarray,
                                                   ms["decoder"]))
    st = slam.store
    depths = st.depths.numpy().copy()
    jstore = types.SimpleNamespace(
        est_c2w=jnp.asarray(st.est_c2w.numpy()), count=st.count,
        depths_float=lambda: jnp.asarray(depths))
    jm = jmesher.Mesher(cfg, jscene, JCamera.from_cfg(cfg))
    jpath = str(tmp_path / "jax_mesh.ply")
    jm.get_mesh(jpath, jms, jstore)

    bound = np.asarray(scene.bound, np.float32)
    pts = mesher.hull_points_device(st, slam.cam, bound)
    jpts = jmesher.hull_points_device(jstore, JCamera.from_cfg(cfg),
                                      jscene.bound_array)
    np.testing.assert_array_equal(pts, jpts)
    vol, _ = slam.mesher.eval_sdf_volume(slam.map_state,
                                         mesher.HullBound(pts, device="cpu"))
    jvol, _ = jm.eval_sdf_volume(jms, jmesher.HullBound(jpts))
    np.testing.assert_allclose(vol.numpy(), np.asarray(jvol), atol=1e-5,
                               rtol=0)
    tv, tf = marching.extract_isosurface_device(torch.tensor(np.asarray(
        jvol)))
    jv, jf = jax_extract(np.asarray(jvol))
    assert_same_mesh(tv.numpy(), tf.numpy(), jv, jf)

    jv, jf, jc = jply.read_ply(jpath)
    assert len(jf) == len(f) and len(jv) == len(v)
    assert np.abs(c.astype(int) - jc.astype(int)).max() <= 1
    ours = str(mesh_dir / "final_mesh.ply")
    res = eval_recon.calc_3d_metric(ours, jpath, num_points=50_000)
    assert res == jeval.calc_3d_metric(ours, jpath, num_points=50_000)
    # calc_3d_metric samples the two meshes independently, so a mesh
    # against itself reads the sampling's floor (about 0.84 cm here at
    # 50,000 points); the two meshes are within 1 % of the 0.25 m
    # resolution (0.25 cm) of that floor.
    floor = eval_recon.calc_3d_metric(jpath, jpath, num_points=50_000)
    for k in ("accuracy_cm", "completion_cm"):
        assert abs(res[k] - floor[k]) < 0.25, (res, floor)


# -- the entry points ----------------------------------------------------------


@pytest.mark.parametrize("mode,cold_s,want", [
    ("on", "90", "pending"), ("off", "90", "skipped(--mesh off)"),
    ("auto", "0", "skipped(cold-cache)")])
def test_bench_torch_mesh_modes(tmp_path, capsys, mode, cold_s, want):
    import json

    import bench_torch

    cfg = tiny_config(tmp_path)
    cfg["data"]["n_frames"] = 2
    path = tmp_path / "bench.yaml"
    path.write_text(yaml.safe_dump(cfg))
    line = bench_torch.main([
        "--config", str(path), "--frames", "2", "--warmup-frames", "1",
        "--device", "cpu", "--lanes", "exact", "--mesh", mode,
        "--cold-threshold-s", cold_s, "--output", str(tmp_path / "b")])
    assert line["final_mesh"] == want
    stdout = capsys.readouterr().out.strip().splitlines()
    assert json.loads(stdout[-1]) == line  # the only line on stdout
    meshed = os.path.exists(tmp_path / "b_exact" / "mesh" /
                            "final_mesh_culled.ply")
    assert meshed == (want == "pending")
    assert os.path.exists(tmp_path / "b_exact" / "ckpts" / "00001.npz")


def test_meshing_failure_raises_after_the_metric_line(tmp_path, capsys,
                                                      monkeypatch):
    import bench_torch

    def broken(*a, **k):
        raise RuntimeError("marching failed")

    monkeypatch.setattr(mesher.Mesher, "get_mesh", broken)
    cfg = tiny_config(tmp_path)
    cfg["data"]["n_frames"] = 2
    path = tmp_path / "bench.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(RuntimeError, match="marching failed"):
        bench_torch.main([
            "--config", str(path), "--frames", "2", "--warmup-frames", "1",
            "--device", "cpu", "--lanes", "exact", "--mesh", "on",
            "--output", str(tmp_path / "b")])
    assert '"final_mesh": "pending"' in capsys.readouterr().out
    # The checkpoint was written before meshing started.
    assert os.path.exists(tmp_path / "b_exact" / "ckpts" / "00001.npz")
