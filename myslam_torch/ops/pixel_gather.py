"""Random-pixel gathers from device imagery buffers (keyframe store)."""

from __future__ import annotations

import torch


def gather_scalar(buf: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """buf: any-shape scalar map; flat: (R,) flattened indices -> (R,)."""
    return buf.reshape(-1)[flat]


def gather_u16(buf: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """buf: uint16 map; flat: (R,) flattened indices -> (R,) int32.

    Reads the bits through an int16 view on every device, since CUDA
    PyTorch has no indexing kernel for uint16."""
    return gather_scalar(buf.view(torch.int16), flat).to(torch.int32) \
        & 0xFFFF


def gather_rgb(buf: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """buf: (..., 3) interleaved; flat: (R,) pixel indices -> (R, 3)."""
    return buf.reshape(-1, 3)[flat]
