"""Mesh geometry utilities: surface sampling, subdivision, depth raster.

The port of ``myslam_tpu/utils/meshmath.py``: the host helpers behind
the reconstruction eval tools are numpy copies; the depth rasterizer is
PyTorch on a device, resolving its z-buffer with a ``scatter_reduce_``
minimum (order-independent, so deterministic).
"""

from __future__ import annotations

import numpy as np
import torch


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Area-weighted uniform point sampling on a triangle mesh (n, 3)."""
    tri = verts[faces]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    total = area.sum()
    if total <= 0:
        raise ValueError("degenerate mesh")
    probs = area / total
    choice = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.uniform(size=(n, 1)))
    r2 = rng.uniform(size=(n, 1))
    t = tri[choice]
    return ((1 - r1) * t[:, 0] + r1 * (1 - r2) * t[:, 1]
            + r1 * r2 * t[:, 2]).astype(np.float32)


def subdivide_to_edge(verts: np.ndarray, faces: np.ndarray,
                      max_edge: float, max_rounds: int = 6):
    """4-split triangles until all edges are shorter than max_edge."""
    verts = verts.astype(np.float64)
    for _ in range(max_rounds):
        tri = verts[faces]
        e = np.stack([
            np.linalg.norm(tri[:, 1] - tri[:, 0], axis=-1),
            np.linalg.norm(tri[:, 2] - tri[:, 1], axis=-1),
            np.linalg.norm(tri[:, 0] - tri[:, 2], axis=-1)], -1)
        big = e.max(-1) > max_edge
        if not big.any():
            break
        keep = faces[~big]
        split = faces[big]
        t = verts[split]
        m01 = 0.5 * (t[:, 0] + t[:, 1])
        m12 = 0.5 * (t[:, 1] + t[:, 2])
        m20 = 0.5 * (t[:, 2] + t[:, 0])
        base = len(verts)
        k = len(split)
        verts = np.concatenate([verts, m01, m12, m20], axis=0)
        i01 = base + np.arange(k)
        i12 = base + k + np.arange(k)
        i20 = base + 2 * k + np.arange(k)
        new = np.stack([
            np.stack([split[:, 0], i01, i20], -1),
            np.stack([i01, split[:, 1], i12], -1),
            np.stack([i20, i12, split[:, 2]], -1),
            np.stack([i01, i12, i20], -1)], 0).reshape(-1, 3)
        faces = np.concatenate([keep, new], axis=0)
    return verts.astype(np.float32), faces.astype(np.int32)


def make_depth_rasterizer(H: int, W: int, fx, fy, cx, cy,
                          chunk: int = 1 << 16, device=None):
    """Perspective-correct triangle z-buffer depth renderer on ``device``
    (default: the GPU).

    Standard CV camera convention (+z forward), matching the Open3D
    offscreen renders the reference's 2-D metric uses
    (eval_recon.py:152-201).  Each triangle rasterizes into an 8 x 8
    pixel window anchored at its screen bbox (pre-subdivide large
    triangles with subdivide_to_edge).  Elementwise operations only, so
    that the card and the CPU round alike.

    Returns render(tris (T, 3, 3) world coords, w2c (4, 4)) -> (H, W)
    depth (0 where empty), with ``render.prep`` (upload the triangles
    once) and ``render.render_dev`` (the device z-buffer, inf where
    empty).
    """
    from myslam_torch import resolve_device

    dev = resolve_device(device)
    patch = 8
    dy, dx = np.meshgrid(np.arange(patch), np.arange(patch), indexing="ij")
    dx = torch.as_tensor(dx.reshape(-1).astype(np.float32)).to(dev)
    dy = torch.as_tensor(dy.reshape(-1).astype(np.float32)).to(dev)

    def raster_chunk(zbuf, tris, w2c):
        R = w2c[:3, :3]
        t = w2c[:3, 3]
        x, y, z = (tris[..., 0] * R[k, 0] + tris[..., 1] * R[k, 1]
                   + tris[..., 2] * R[k, 2] + t[k] for k in range(3))
        valid_tri = (z > 1e-4).all(dim=-1)
        zs = torch.where(valid_tri[:, None], z, 1.0)
        u = fx * x / zs + cx
        v = fy * y / zs + cy

        ax = torch.floor(u.amin(dim=-1))
        ay = torch.floor(v.amin(dim=-1))
        umax, vmax = u.amax(dim=-1), v.amax(dim=-1)
        small = ((umax - ax) < patch) & ((vmax - ay) < patch)
        valid_tri = (valid_tri & small & (umax >= 0) & (ax < W)
                     & (vmax >= 0) & (ay < H))

        px = ax[:, None] + dx[None, :]  # (T, P*P)
        py = ay[:, None] + dy[None, :]

        # edge functions in screen space
        x0, y0 = u[:, 0, None], v[:, 0, None]
        x1, y1 = u[:, 1, None], v[:, 1, None]
        x2, y2 = u[:, 2, None], v[:, 2, None]
        w0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
        w1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
        w2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)  # (T, 1)
        # slivers with ~zero projected area would otherwise pass the
        # inside test with all-zero barycentrics
        degenerate = area[:, 0].abs() < 1e-9
        area = torch.where(area.abs() < 1e-12, 1e-12, area)
        b0, b1, b2 = w0 / area, w1 / area, w2 / area
        # small negative tolerance: pixels exactly on shared edges can
        # round to the same tiny negative value in BOTH triangles (f32),
        # punching pinholes; slight double-coverage is harmless under
        # the z-min resolve.
        eps = -1e-4
        inside = (b0 >= eps) & (b1 >= eps) & (b2 >= eps)

        inv_z = (b0 / zs[:, 0, None] + b1 / zs[:, 1, None]
                 + b2 / zs[:, 2, None])
        z_px = 1.0 / torch.clamp(inv_z, min=1e-9)

        ok = (inside & (valid_tri & ~degenerate)[:, None]
              & (px >= 0) & (px < W) & (py >= 0) & (py < H))
        z_px = torch.where(ok, z_px, torch.inf)
        pxi = torch.clamp(px, 0, W - 1).to(torch.int64)
        pyi = torch.clamp(py, 0, H - 1).to(torch.int64)
        zbuf.view(-1).scatter_reduce_(0, (pyi * W + pxi).reshape(-1),
                                      z_px.reshape(-1), "amin")
        return zbuf

    def prep(tris: np.ndarray) -> torch.Tensor:
        """Upload the triangles once (the 2-D metric renders the same
        meshes from many views)."""
        return torch.as_tensor(np.asarray(tris, np.float32)).to(dev)

    def render_dev(tris_dev, w2c) -> torch.Tensor:
        """Device z-buffer (inf where empty) — no host fetch."""
        zbuf = torch.full((H, W), torch.inf, device=dev)
        w2c_d = torch.as_tensor(np.asarray(w2c, np.float32)).to(dev)
        for i in range(0, tris_dev.shape[0], chunk):
            zbuf = raster_chunk(zbuf, tris_dev[i:i + chunk], w2c_d)
        return zbuf

    def render(tris: np.ndarray, w2c: np.ndarray) -> np.ndarray:
        out = render_dev(prep(tris), w2c).cpu().numpy()
        out[~np.isfinite(out)] = 0.0
        return out

    render.prep = prep
    render.render_dev = render_dev
    return render


def _min_area_rect(xy: np.ndarray):
    """Rotating-calipers minimum-area rectangle of 2-D points.

    Returns (angle, area, (w, h)): rotating by -angle axis-aligns the
    rectangle.  The optimum is aligned with some convex-hull edge."""
    from scipy.spatial import ConvexHull

    hull = xy[ConvexHull(xy).vertices]
    edges = np.diff(np.vstack([hull, hull[:1]]), axis=0)
    angles = np.unique(np.mod(np.arctan2(edges[:, 1], edges[:, 0]),
                              0.5 * np.pi))
    best = None
    for a in angles:
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, s], [-s, c]])
        p = hull @ R.T
        w, h = np.ptp(p, axis=0)
        if best is None or w * h < best[1]:
            best = (a, w * h, (w, h))
    return best


def oriented_bounds(points: np.ndarray):
    """Minimal-volume oriented bounding box (hull-facet heuristic — the
    same family as trimesh.bounds.oriented_bounds, which the reference
    uses for its 2-D-metric camera sampling volume, eval_recon.py:117-124):
    for every convex-hull facet orientation, rotate the facet normal to
    +z and solve the projected 2-D minimum-area rectangle; keep the
    minimum-volume candidate.

    Returns (to_origin (4, 4), extents (3,)): ``to_origin`` maps world
    points into the box frame (centered at the origin), with axes
    ordered so extents are sorted LARGEST to smallest (trimesh's
    ``ordered=True`` convention) and the frame right-handed.
    """
    from scipy.spatial import ConvexHull

    points = np.asarray(points, np.float64)
    hull = ConvexHull(points)
    hp = points[hull.vertices]
    # The facet-orientation sweep is O(facets x hull edges): fine for
    # room-shaped hulls (dozens of facets), quadratic blow-up on smooth
    # dense surfaces where EVERY vertex is on the hull (a subdivided
    # sphere hung here for minutes).  Cap the candidate hull size — the
    # OBB of a uniformly subsampled hull is within a fraction of a
    # percent for smooth shapes, and the consumer (the 2-D metric's
    # camera sampling volume, reference eval_recon.py:117-124, already
    # scaled by [0.3, 0.7, 0.7]) is tolerance-insensitive.
    max_hull = 400
    if len(hp) > max_hull:
        sel = np.random.default_rng(0).choice(
            len(hp), max_hull, replace=False)
        hull = ConvexHull(hp[sel])
        hp = hp[sel][hull.vertices]
    normals = hull.equations[:, :3]
    seen = set()
    best = None
    for n in normals:
        # dedupe facet orientations (+n / -n give the same slab)
        key = tuple(np.round(np.abs(n), 5))
        if key in seen:
            continue
        seen.add(key)
        n = n / np.linalg.norm(n)
        # orthonormal basis with n as z
        a = np.array([1.0, 0.0, 0.0])
        if abs(n[0]) > 0.9:
            a = np.array([0.0, 1.0, 0.0])
        x = np.cross(a, n)
        x /= np.linalg.norm(x)
        y = np.cross(n, x)
        R = np.stack([x, y, n])  # world -> facet frame
        p = hp @ R.T
        zext = np.ptp(p[:, 2])
        ang, area, (w, h) = _min_area_rect(p[:, :2])
        vol = area * zext
        if best is None or vol < best[0]:
            c, s = np.cos(ang), np.sin(ang)
            R2 = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
            best = (vol, R2 @ R)
    R = best[1]
    p = hp @ R.T
    lo, hi = p.min(axis=0), p.max(axis=0)
    extents = hi - lo
    center_box = 0.5 * (lo + hi)
    # order axes by extent, largest first; keep right-handedness
    order = np.argsort(-extents)
    R = R[order]
    extents = extents[order]
    center_box = center_box[order]
    if np.linalg.det(R) < 0:
        R[2] = -R[2]
        center_box[2] = -center_box[2]
    to_origin = np.eye(4)
    to_origin[:3, :3] = R
    to_origin[:3, 3] = -center_box
    return to_origin, extents
