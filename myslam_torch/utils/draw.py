"""Raster drawing in numpy for the port's images (no plotting library):
polylines and dots on an (H, W, 3) uint8 canvas, and the view that fits
2-D points into one."""

from __future__ import annotations

import numpy as np

RED = (255, 0, 0)
GREEN = (0, 160, 0)


def fit_view(points: np.ndarray, H: int, W: int, margin: float = 0.08):
    """A projection of 2-D points (N, 2) into an H x W canvas: same scale
    on both axes, y up, the points' box centered with ``margin`` of the
    canvas on each side.  Returns project(xy (M, 2)) -> (u (M,), v (M,))
    in pixels."""
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    scale = min((1.0 - 2 * margin) * W / span[0],
                (1.0 - 2 * margin) * H / span[1])
    mid = (lo + hi) / 2.0

    def project(xy):
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        return (W / 2.0 + (xy[:, 0] - mid[0]) * scale,
                H / 2.0 - (xy[:, 1] - mid[1]) * scale)

    return project


def _stamp(img: np.ndarray, u: np.ndarray, v: np.ndarray, color,
           radius: int) -> None:
    H, W = img.shape[:2]
    ui, vi = np.rint(u).astype(np.int64), np.rint(v).astype(np.int64)
    for dv in range(-radius, radius + 1):
        for du in range(-radius, radius + 1):
            if du * du + dv * dv > radius * radius + radius:
                continue
            x, y = ui + du, vi + dv
            ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            img[y[ok], x[ok]] = color


def draw_polyline(img: np.ndarray, u, v, color, width: int = 2) -> None:
    """The segments between consecutive points (u, v) in pixels, drawn
    in place ``width`` pixels wide."""
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    if len(u) == 0:
        return
    if len(u) == 1:
        _stamp(img, u, v, color, max(width // 2, 0))
        return
    seg = np.hypot(np.diff(u), np.diff(v))
    steps = np.maximum(np.ceil(seg * 2).astype(np.int64), 1)
    t = np.concatenate([np.arange(n) / n for n in steps] + [[1.0]])
    k = np.concatenate([np.full(n, i) for i, n in enumerate(steps)]
                       + [[len(seg) - 1]])
    su = u[k] + (u[k + 1] - u[k]) * t
    sv = v[k] + (v[k + 1] - v[k]) * t
    _stamp(img, su, sv, color, max(width // 2, 0))


def draw_dot(img: np.ndarray, u: float, v: float, color,
             radius: int = 4) -> None:
    _stamp(img, np.array([u]), np.array([v]), color, radius)
