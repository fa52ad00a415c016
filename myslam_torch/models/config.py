"""Model factory: the decoders a config asks for."""

from __future__ import annotations

import torch

from myslam_torch.models.decoders import Decoders


def get_model(cfg: dict, generator: torch.Generator | None = None):
    """Decoders per the config's model section.  beta starts at 10 either
    way; ``rendering.learnable_beta`` only decides whether the mapper's
    optimizer updates it."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    n_levels = 2  # coarse + fine planes
    return Decoders(in_dim=n_levels * int(cfg["model"]["c_dim"]),
                    beta_init=10.0, generator=generator)
