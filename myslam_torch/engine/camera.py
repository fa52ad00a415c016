"""Camera intrinsics with the reference's crop/resize preprocessing: an
optional resize to ``crop_size`` rescales focal lengths and principal
point, then ``crop_edge`` shrinks the image and shifts the principal
point."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Camera:
    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def from_cfg(cls, cfg: dict) -> "Camera":
        cam = cfg["cam"]
        H, W = cam["H"], cam["W"]
        fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
        if "crop_size" in cam:
            sx = cam["crop_size"][1] / W
            sy = cam["crop_size"][0] / H
            fx, fy, cx, cy = sx * fx, sy * fy, sx * cx, sy * cy
            W, H = cam["crop_size"][1], cam["crop_size"][0]
        edge = cam.get("crop_edge", 0)
        if edge > 0:
            H -= 2 * edge
            W -= 2 * edge
            cx -= edge
            cy -= edge
        return cls(H=H, W=W, fx=fx, fy=fy, cx=cx, cy=cy)
