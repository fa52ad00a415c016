"""Tri-plane scene representation as fused feature atlases.

All planes of one field (sdf or color) — {coarse, fine} x {xy, xz, yz} —
are packed row-major into one channels-last atlas of shape (sum_HW, C),
the layout of ``myslam_tpu.models.planes``.  A point sample is then a
gather of rows from one tensor, and the atlas is one optimizer leaf.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# (u-axis, v-axis) of each plane; u indexes the plane's W (fast) axis.
# Order (xy, xz, yz), shapes xy=(ny,nx), xz=(nz,nx), yz=(nz,ny).
ORIENTATIONS = ((0, 1), (0, 2), (1, 2))


@dataclass(frozen=True)
class PlaneLayout:
    """Static geometry of a plane atlas.

    shapes[level][orientation] = (H, W); offsets give each plane's first
    row in the fused atlas.
    """

    shapes: tuple
    offsets: tuple
    total_rows: int
    c_dim: int

    @property
    def n_levels(self) -> int:
        return len(self.shapes)

    def planes(self):
        """Per-plane (level, orientation, u-axis, v-axis, H, W, offset)
        tuples in atlas order."""
        out = []
        for lvl in range(self.n_levels):
            for ori, (au, av) in enumerate(ORIENTATIONS):
                H, W = self.shapes[lvl][ori]
                out.append((lvl, ori, au, av, H, W, self.offsets[lvl][ori]))
        return out


@dataclass(frozen=True)
class BandLayout:
    """One map shard's band of every plane of a layout
    (``parallel/plane_shard.py``): plane k's rows [y_lo[k], y_lo[k] +
    band_h[k]) as a band atlas of ``total_rows`` rows, plane k's band at
    row ``local_off[k]``.  ``shapes`` are the whole planes'."""

    shapes: tuple
    local_off: tuple
    y_lo: tuple
    band_h: tuple
    total_rows: int
    c_dim: int

    @property
    def n_levels(self) -> int:
        return len(self.shapes)

    def planes(self):
        """Per-plane (level, orientation, u-axis, v-axis, H, W, band
        offset, y_lo, band_h) tuples in atlas order."""
        out = []
        for lvl in range(self.n_levels):
            for ori, (au, av) in enumerate(ORIENTATIONS):
                k = 3 * lvl + ori
                H, W = self.shapes[lvl][ori]
                out.append((lvl, ori, au, av, H, W, self.local_off[k],
                            self.y_lo[k], self.band_h[k]))
        return out


def make_layout(bound, resolutions, c_dim: int) -> PlaneLayout:
    """PlaneLayout from the scene bound (3, 2) and per-level resolutions
    in meters; grid sizes truncate the axis length / resolution."""
    bound = np.asarray(bound)
    xyz_len = (bound[:, 1] - bound[:, 0]).tolist()
    shapes, offsets = [], []
    off = 0
    for res in resolutions:
        nx, ny, nz = (int(length / res) for length in xyz_len)
        level_shapes = ((ny, nx), (nz, nx), (nz, ny))
        level_offsets = []
        for (h, w) in level_shapes:
            level_offsets.append(off)
            off += h * w
        shapes.append(level_shapes)
        offsets.append(tuple(level_offsets))
    return PlaneLayout(shapes=tuple(shapes), offsets=tuple(offsets),
                       total_rows=off, c_dim=c_dim)


def compute_bound(cfg: dict) -> np.ndarray:
    """Scene bound (3, 2) float32 with each upper edge rounded up to a
    multiple of ``planes_res.bound_dividable`` above the lower edge."""
    scale = cfg.get("scale", 1)
    bound = np.array(cfg["mapping"]["bound"], dtype=np.float64) * scale
    div = cfg["planes_res"]["bound_dividable"]
    bound[:, 1] = (
        ((bound[:, 1] - bound[:, 0]) / div).astype(int) + 1
    ) * div + bound[:, 0]
    return bound.astype(np.float32)


@dataclass
class MapState:
    """The differentiable scene: two atlases and the decoders.

    The atlases are leaf tensors; the mapper's optimizer updates them in
    place, so a MapState stays the same object across mapped frames.
    """

    sdf_atlas: torch.Tensor  # (S_sdf, C)
    color_atlas: torch.Tensor  # (S_color, C)
    decoder: torch.nn.Module  # models.decoders.Decoders


def init_map_state(generator: torch.Generator, sdf_layout: PlaneLayout,
                   color_layout: PlaneLayout, decoder: torch.nn.Module,
                   std: float = 0.01, device="cpu") -> MapState:
    """Atlases ~ N(0, std^2), drawn from ``generator`` (a CPU generator,
    so a seed gives the same map on every device)."""
    sdf = std * torch.randn((sdf_layout.total_rows, sdf_layout.c_dim),
                            generator=generator)
    col = std * torch.randn((color_layout.total_rows, color_layout.c_dim),
                            generator=generator)
    return MapState(sdf_atlas=sdf.to(device).requires_grad_(),
                    color_atlas=col.to(device).requires_grad_(),
                    decoder=decoder.to(device))
