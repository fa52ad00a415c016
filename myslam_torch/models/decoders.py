"""Shallow SDF / RGB decoder MLPs over plane-atlas features.

Two independent MLPs (in = n_levels * c_dim, hidden 16, two ReLU blocks)
with a tanh SDF head and a sigmoid RGB head, plus the learnable
sharpness ``beta`` (init 10), as in the reference's decoders.
Initialization is torch.nn.Linear's: W, b ~ U(-1/sqrt(fan_in),
1/sqrt(fan_in)), drawn from an explicit generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Decoders(nn.Module):
    """SDF and RGB decoders; weights in nn.Linear's (out, in) layout."""

    def __init__(self, in_dim: int = 64, hidden: int = 16, n_blocks: int = 2,
                 beta_init: float = 10.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [in_dim] + [hidden] * n_blocks
        self.sdf = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.rgb = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.sdf_out = nn.Linear(hidden, 1)
        self.rgb_out = nn.Linear(hidden, 3)
        self.beta = nn.Parameter(torch.tensor([float(beta_init)]))
        if generator is not None:
            self.reset_parameters(generator)

    def linears(self):
        """Every Linear, in a fixed order (sdf blocks, rgb blocks, heads)."""
        return [*self.sdf, *self.rgb, self.sdf_out, self.rgb_out]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in self.linears():
            bound = 1.0 / math.sqrt(lin.in_features)
            for p in (lin.weight, lin.bias):
                u = torch.rand(p.shape, generator=generator)
                p.copy_((2.0 * u - 1.0) * bound)

    def mlp_params(self):
        """All parameters but beta."""
        return [p for lin in self.linears() for p in lin.parameters()]


def _mlp(layers, out_layer, feat):
    h = feat
    for lin in layers:
        h = F.relu(lin(h))
    return out_layer(h)


def decode_sdf(dec: Decoders, feat: torch.Tensor) -> torch.Tensor:
    """(N, L*C) features -> (N,) sdf in (-1, 1)."""
    return torch.tanh(_mlp(dec.sdf, dec.sdf_out, feat))[..., 0]


def decode_rgb(dec: Decoders, feat: torch.Tensor) -> torch.Tensor:
    """(N, L*C) features -> (N, 3) rgb in (0, 1)."""
    return torch.sigmoid(_mlp(dec.rgb, dec.rgb_out, feat))


def _mlp_corners(layers, out_layer, corners, row_map):
    """MLP whose first layer takes the unreduced corner features.

    The corner/level reduction is a constant block-identity matrix M, so
    (corners @ M) @ W1^T == corners @ W1[:, row_map]^T: the reduction
    rides the first layer's matmul instead of costing its own pass.
    """
    first = layers[0]
    h = F.relu(F.linear(corners, first.weight[:, row_map], first.bias))
    for lin in layers[1:]:
        h = F.relu(lin(h))
    return out_layer(h)


def decode_sdf_corners(dec: Decoders, corners: torch.Tensor,
                       row_map: torch.Tensor) -> torch.Tensor:
    """(N, L*4C) weighted corner features -> (N,) sdf."""
    return torch.tanh(_mlp_corners(dec.sdf, dec.sdf_out, corners,
                                   row_map))[..., 0]


def decode_rgb_corners(dec: Decoders, corners: torch.Tensor,
                       row_map: torch.Tensor) -> torch.Tensor:
    """(N, L*4C) weighted corner features -> (N, 3) rgb."""
    return torch.sigmoid(_mlp_corners(dec.rgb, dec.rgb_out, corners,
                                      row_map))
