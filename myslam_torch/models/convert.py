"""Conversion between the JAX package's map state and the port's.

The JAX ``MapState`` holds two atlases and a decoder dict whose weights
are (in, out) matrices:
``{"sdf": [[w, b], ...], "rgb": [[w, b], ...], "sdf_out": [w, b],
"rgb_out": [w, b], "beta": (1,)}``.  Given as numpy arrays, the same
numbers become the port's MapState, so both packages compute the same
function.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from myslam_torch.models.decoders import Decoders
from myslam_torch.models.planes import MapState


def _field(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def decoder_from_jax_numpy(dec: dict, device="cpu") -> Decoders:
    """A JAX decoder dict (numpy leaves) as a Decoders module."""
    sdf_layers = dec["sdf"]
    in_dim, hidden = np.shape(sdf_layers[0][0])
    out = Decoders(in_dim=in_dim, hidden=hidden, n_blocks=len(sdf_layers))
    pairs = [*dec["sdf"], *dec["rgb"], dec["sdf_out"], dec["rgb_out"]]
    with torch.no_grad():
        for lin, (w, b) in zip(out.linears(), pairs):
            lin.weight.copy_(torch.tensor(np.asarray(w, np.float32).T))
            lin.bias.copy_(torch.tensor(np.asarray(b, np.float32)))
        out.beta.copy_(torch.tensor(np.asarray(dec["beta"], np.float32)))
    return out.to(device)


def from_jax_numpy(tree, device="cpu") -> MapState:
    """A JAX MapState (or dict with its three fields) with numpy leaves
    -> the port's MapState on ``device``."""
    def atlas(name):
        a = np.asarray(_field(tree, name), np.float32)
        return torch.tensor(a, device=device, requires_grad=True)

    return MapState(sdf_atlas=atlas("sdf_atlas"),
                    color_atlas=atlas("color_atlas"),
                    decoder=decoder_from_jax_numpy(_field(tree, "decoder"),
                                                   device))


def decoder_to_jax_numpy(dec: Decoders) -> dict:
    """A Decoders module as the JAX decoder dict, numpy leaves."""
    def wb(lin):
        return [lin.weight.detach().cpu().numpy().T.copy(),
                lin.bias.detach().cpu().numpy().copy()]

    return {
        "sdf": [wb(lin) for lin in dec.sdf],
        "rgb": [wb(lin) for lin in dec.rgb],
        "sdf_out": wb(dec.sdf_out),
        "rgb_out": wb(dec.rgb_out),
        "beta": dec.beta.detach().cpu().numpy(),
    }


def to_jax_numpy(ms: MapState) -> dict:
    """The port's MapState as the JAX layout, numpy leaves."""
    return {
        "sdf_atlas": ms.sdf_atlas.detach().cpu().numpy(),
        "color_atlas": ms.color_atlas.detach().cpu().numpy(),
        "decoder": decoder_to_jax_numpy(ms.decoder),
    }
