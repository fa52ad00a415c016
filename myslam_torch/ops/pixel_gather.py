"""Random-pixel gathers from device imagery buffers (keyframe store)."""

from __future__ import annotations

import torch


def gather_scalar(buf: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """buf: any-shape scalar map; flat: (R,) flattened indices -> (R,)."""
    return buf.reshape(-1)[flat]


def gather_rgb(buf: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """buf: (..., 3) interleaved; flat: (R,) pixel indices -> (R, 3)."""
    return buf.reshape(-1, 3)[flat]
