"""Mesh extraction: scene bound hull, SDF volume query, isosurface, colors.

The port of ``myslam_tpu/utils/mesher.py``:

  * the observed-space bound: the convex hull (scipy/qhull, on the host)
    of a point set, scaled 1.02, with the containment test on the
    device.  For the device and packed stores the points are the corners
    of every coarse voxel that a back-projected keyframe depth sample
    falls in, plus the camera centers, with the votes counted on the
    device; for the host-staged store, whose depths are on the host, the
    back-projected samples themselves (``backproject_keyframes``) after
    a voxel-vote denoise (``denoise_observed_points``);
  * the SDF volume, queried in chunks of whole x-rows (about
    ``points_batch_size`` points each, z fastest) through
    ``render/renderer.py::query_sdf``: a CUDA tensor reaches kernel K1
    once per chunk.  The quads are packed once per mesh and cast to
    bfloat16 (no gradients here);
  * the isosurface, by ``ops/marching.py`` on the volume's device;
  * vertex colors from the color decoder at the vertices (uint8).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
from scipy.spatial import ConvexHull

from myslam_torch.core.geometry import normalize_3d_coordinate, rays_from_uv
from myslam_torch.ops.marching import extract_isosurface_device
from myslam_torch.ops.plane_sample import pack_quad
from myslam_torch.render.renderer import SceneGeometry, query_rgb, query_sdf
from myslam_torch.utils.ply import write_ply


def voxel_votes(c2ws: torch.Tensor, depths: torch.Tensor, count: int, cam,
                stride: int, origin: torch.Tensor, inv_voxel: float,
                dims: tuple, inv_q: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Votes (nx*ny*nz,) int32 of a coarse voxel grid: for each of the
    first ``count`` store slots, its depth map back-projected on every
    ``stride``-th pixel, one vote per valid sample in its voxel.
    ``depths`` float32, or uint16 with the per-slot scale ``inv_q``
    (dequantized one slot at a time)."""
    dev = depths.device
    j, i = torch.meshgrid(
        torch.arange(0, cam.H, stride, dtype=torch.float32, device=dev),
        torch.arange(0, cam.W, stride, dtype=torch.float32, device=dev),
        indexing="ij")
    nx, ny, nz = dims
    votes = torch.zeros((nx * ny * nz,), dtype=torch.int32, device=dev)
    for slot in range(count):
        depth = depths[slot, ::stride, ::stride]
        if inv_q is not None:
            depth = depth.to(torch.float32) * inv_q[slot]
        rays_o, rays_d = rays_from_uv(i, j, c2ws[slot], cam.fx, cam.fy,
                                      cam.cx, cam.cy)
        pts = rays_o + rays_d * depth[..., None]
        cell = torch.floor((pts - origin) * inv_voxel).to(torch.int64)
        inb = ((cell >= 0).all(dim=-1) & (cell[..., 0] < nx)
               & (cell[..., 1] < ny) & (cell[..., 2] < nz) & (depth > 0))
        flat = (cell[..., 0] * ny + cell[..., 1]) * nz + cell[..., 2]
        flat = flat[inb]
        votes.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return votes


def hull_points_device(store, cam, bound: np.ndarray,
                       min_votes: int = 1) -> np.ndarray:
    """Observed-space point set for the bound hull.

    Votes of every 8th pixel accumulate on the device in a 10 cm grid
    over the bound padded by 30 cm; the host reads the grid, keeps cells
    with >= min_votes and emits the 8 CORNERS of each occupied voxel (a
    superset hull of the contained points) plus the camera centers.
    ``bound`` (3, 2) float32.  A device or packed store."""
    stride, voxel, margin = 8, 0.1, 0.3
    lo = bound[:, 0] - margin
    hi = bound[:, 1] + margin
    dims = tuple(int(np.ceil((hi[a] - lo[a]) / voxel)) for a in range(3))
    dev = store.est_c2w.device
    depths, inv_q = ((store.depths_u16, store.depth_inv_q) if store.packed
                     else (store.depths, None))
    votes = voxel_votes(
        store.est_c2w, depths, store.count, cam, stride,
        torch.as_tensor(np.asarray(lo, np.float32)).to(dev),
        float(np.float32(1.0 / voxel)), dims, inv_q)
    v = votes.cpu().numpy().reshape(dims)
    occ = np.argwhere(v >= max(min_votes, 1))
    if len(occ) == 0:
        occ = np.zeros((1, 3), np.int64)
    corners = occ[:, None, :] + np.array(
        [[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)])
    pts = lo[None, None, :] + corners * voxel
    cams = store.est_c2w[:store.count, :3, 3].cpu().numpy()
    return np.concatenate([pts.reshape(-1, 3), cams], axis=0)


def backproject_keyframes(store, cam) -> np.ndarray:
    """Point cloud of a host-staged store's keyframe depths, on every
    8th pixel, then the camera centers: dequantized and back-projected in
    numpy, where the depths are."""
    stride = 8
    n = store.count
    est = store.est_c2w[:n].cpu().numpy()
    d = (store.depths_u16[:n, ::stride, ::stride].numpy().astype(np.float32)
         * store.depth_inv_q[:n, None, None].numpy())
    j, i = np.meshgrid(
        np.arange(0, cam.H, stride, dtype=np.float32),
        np.arange(0, cam.W, stride, dtype=np.float32), indexing="ij")
    dirs = np.stack([(i - cam.cx) / cam.fx, -(j - cam.cy) / cam.fy,
                     -np.ones_like(i)], axis=-1)  # (h, w, 3)
    pts = (np.einsum("khwj,kij->khwi", dirs[None] * d[..., None],
                     est[:, :3, :3]) + est[:, None, None, :3, 3])
    return np.concatenate([pts[d > 0], est[:, :3, 3]], axis=0)


def denoise_observed_points(pts: np.ndarray, n_cams: int,
                            min_votes: int = 3) -> np.ndarray:
    """Voxel-vote outlier rejection before hull construction: only
    points in 10 cm voxels holding >= min_votes samples survive (surfaces
    are dense under the strided back-projection, isolated depth spikes
    are not).  The trailing ``n_cams`` rows are the camera centers and
    always survive."""
    voxel = 0.1
    if min_votes <= 1 or len(pts) <= n_cams:
        return pts
    surf = pts[:len(pts) - n_cams]
    cams = pts[len(pts) - n_cams:]
    keys = np.floor(surf / voxel).astype(np.int64)
    # 3 x int21 packed into one int64 key for fast uniquing.
    packed = ((keys[:, 0] & 0x1FFFFF) << 42 | (keys[:, 1] & 0x1FFFFF) << 21
              | (keys[:, 2] & 0x1FFFFF))
    _, inv, counts = np.unique(packed, return_inverse=True,
                               return_counts=True)
    keep = counts[inv] >= min_votes
    return np.concatenate([surf[keep], cams], axis=0)


class HullBound:
    """Convex hull of observed space with a containment test on
    ``device`` (default: the GPU): half-spaces ``A @ x + b <= 0``, at
    most 256 of them (every k-th kept beyond that)."""

    def __init__(self, points: np.ndarray, scale: float = 1.02,
                 device=None):
        from myslam_torch import resolve_device

        hull = ConvexHull(points)
        verts = points[hull.vertices]
        center = verts.mean(axis=0)
        scaled = center + (verts - center) * scale
        hull2 = ConvexHull(scaled)
        A = hull2.equations[:, :3].astype(np.float32)
        b = hull2.equations[:, 3].astype(np.float32)
        capacity = 256
        if len(A) > capacity:  # extremely complex hull: keep every k-th
            keep = np.linspace(0, len(A) - 1, capacity).astype(int)
            A, b = A[keep], b[keep]
        self.A = torch.as_tensor(A).to(resolve_device(device))
        self.b = torch.as_tensor(b).to(self.A.device)

    def contains(self, pts: torch.Tensor) -> torch.Tensor:
        """(N, 3) -> (N,) bool."""
        side = pts @ self.A.T + self.b[None, :]
        return (side <= 1e-6).all(dim=-1)


class Mesher:
    """Extract a colored triangle mesh from the map state.

    After ``get_mesh``, ``stages`` holds the seconds of each stage (hull,
    sdf_volume, marching, vertex_colors, fetch, write_ply), each ended by
    a device synchronize; they print to stderr with ``verbose`` or
    MYSLAM_TIMING=1.
    """

    def __init__(self, cfg: dict, scene: SceneGeometry, cam,
                 points_batch_size: int = 500_000):
        self.scene = scene
        self.cam = cam
        self.resolution = float(cfg["meshing"]["resolution"])
        self.level_set = float(cfg["meshing"]["level_set"])
        self.mesh_bound_scale = float(cfg["meshing"]["mesh_bound_scale"])
        # Voxel-vote threshold of the hull's point set; 1 keeps every
        # voxel with a sample (the TUM configs raise it).
        self.bound_min_votes = int(cfg["meshing"].get("bound_min_votes", 1))
        self.scale = cfg.get("scale", 1)
        self.mc_bound = np.array(
            cfg["mapping"]["marching_cubes_bound"], np.float64) * self.scale
        self.points_batch_size = points_batch_size
        # Vertices per color query.
        self.color_batch = min(points_batch_size, 1 << 20)
        self.verbose = cfg.get("verbose", False)
        self.stages: dict = {}

    def grid_axes(self):
        """Reference get_grid_uniform axes (Mesher.py:159-186): linspace
        over the marching-cubes bound padded by 5 cm."""
        padding = 0.05
        axes = []
        for a in range(3):
            lo, hi = self.mc_bound[a]
            n = int(round((hi - lo + 2 * padding) / self.resolution))
            axes.append(np.linspace(lo - padding, hi + padding, n,
                                    dtype=np.float32))
        return axes

    def volume_chunks(self) -> list:
        """(first, end) x-rows of each chunk of the volume pass: whole
        x-rows, ``points_batch_size // (ny * nz)`` of them (at least
        one); the last chunk may be thinner."""
        xs, ys, zs = self.grid_axes()
        rows = max(self.points_batch_size // (len(ys) * len(zs)), 1)
        return [(x0, min(x0 + rows, len(xs)))
                for x0 in range(0, len(xs), rows)]

    def chunk_points(self, x0: int, x1: int, device) -> torch.Tensor:
        """World points of one volume chunk, as the volume pass makes
        them (x-rows x0..x1-1, z fastest)."""
        xs, ys, zs = (torch.as_tensor(a).to(device)
                      for a in self.grid_axes())
        return torch.stack(torch.meshgrid(xs[x0:x1], ys, zs, indexing="ij"),
                           dim=-1).reshape(-1, 3)

    def eval_sdf_volume(self, ms, hull: HullBound | None):
        """Dense SDF volume over the grid on the map's device; points out
        of the hull or the bound are set to -1 (reference
        Mesher.py:146-153, 210-217).  SDF only: color is queried at the
        vertices alone.  Returns (volume (nx, ny, nz) f32, (xs, ys, zs))."""
        xs, ys, zs = self.grid_axes()
        dev = ms.sdf_atlas.device
        bound = self.scene.bound_tensor(dev)
        vol = torch.empty((len(xs), len(ys), len(zs)), dtype=torch.float32,
                          device=dev)
        with torch.no_grad():
            sdf_quad = pack_quad(ms.sdf_atlas.detach(),
                                 self.scene.sdf_layout).to(torch.bfloat16)
            for x0, x1 in self.volume_chunks():
                g = self.chunk_points(x0, x1, dev)
                p_nor = normalize_3d_coordinate(g, bound)
                sdf = query_sdf(ms, self.scene, p_nor, sdf_quad)
                inb = ((g > bound[:, 0]) & (g < bound[:, 1])).all(dim=-1)
                if hull is not None:
                    inb = inb & hull.contains(g)
                vol[x0:x1] = torch.where(inb, sdf, -1.0).reshape(
                    x1 - x0, len(ys), len(zs))
        return vol, (xs, ys, zs)

    def vertex_colors_u8_device(self, ms, verts: torch.Tensor) -> torch.Tensor:
        """uint8 vertex colors (V, 3) for WORLD-coordinate vertices on the
        map's device, ``color_batch`` vertices per query."""
        bound = self.scene.bound_tensor(verts.device)
        out = torch.empty((verts.shape[0], 3), dtype=torch.uint8,
                          device=verts.device)
        with torch.no_grad():
            color_quad = pack_quad(ms.color_atlas.detach(),
                                   self.scene.color_layout).to(
                                       torch.bfloat16)
            for s in range(0, verts.shape[0], self.color_batch):
                p_nor = normalize_3d_coordinate(
                    verts[s:s + self.color_batch], bound)
                rgb = query_rgb(ms, self.scene, p_nor, color_quad)
                out[s:s + self.color_batch] = torch.clamp(
                    torch.round(rgb * 255.0), 0, 255).to(torch.uint8)
        return out

    def get_mesh(self, out_file: str, ms, store) -> str:
        """Extract and save the mesh (reference Mesher.get_mesh); every
        stage before the fetch runs on the map's device."""
        timing = os.environ.get("MYSLAM_TIMING", "0") == "1" or self.verbose
        dev = ms.sdf_atlas.device
        self.stages = {}
        last = [time.perf_counter()]

        def mark(name):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            self.stages[name] = now - last[0]
            last[0] = now
            if timing:
                print(f"[mesher] {name}: {self.stages[name]:.1f} s",
                      file=sys.stderr, flush=True)

        hull = None
        if store is not None and store.count > 0:
            if store.host_mode:
                pts = denoise_observed_points(
                    backproject_keyframes(store, self.cam), store.count,
                    min_votes=self.bound_min_votes)
            else:
                pts = hull_points_device(
                    store, self.cam, np.asarray(self.scene.bound,
                                                np.float32),
                    min_votes=self.bound_min_votes)
            hull = HullBound(pts, self.mesh_bound_scale, device=dev)
        mark("hull")
        vol, (xs, ys, zs) = self.eval_sdf_volume(ms, hull)
        mark("sdf_volume")
        verts_d, faces_d = extract_isosurface_device(vol, level=self.level_set)
        del vol
        mark("marching")
        if faces_d.shape[0] == 0:
            write_ply(out_file, np.zeros((0, 3), np.float32),
                      np.zeros((0, 3), np.int32), None)
            return out_file
        origin = torch.as_tensor(
            np.array([xs[0], ys[0], zs[0]], np.float32)).to(dev)
        spacing = torch.as_tensor(np.array(
            [xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0]], np.float32)).to(dev)
        verts_world = origin + verts_d * spacing
        colors = self.vertex_colors_u8_device(ms, verts_world).cpu().numpy()
        mark("vertex_colors")
        verts = verts_world.cpu().numpy()
        faces = faces_d.cpu().numpy()
        mark("fetch")
        write_ply(out_file, verts / self.scale, faces, colors)
        mark("write_ply")
        if self.verbose:
            print(f"Saved mesh ({len(verts)} verts, {len(faces)} faces) "
                  f"at {out_file}")
        return out_file
