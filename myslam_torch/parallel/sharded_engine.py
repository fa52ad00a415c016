"""The banded map as a renderer backend for the frame mapper.

The port of ``myslam_tpu/parallel/sharded_engine.py``.
``parallel/plane_shard.py`` gives the band-sharded atlases and their
halo-exchanged sampling; this module makes them a ``FieldQueries``
backend (``queries_factory``), so that the whole frame mapper
(``engine/mapper.make_frame_mapper``: selection, the iterations, the pose
write-back, admission, the importance branch, the packed store) runs
against a map whose atlases are split over the ranks:

  * each rank holds its band of every plane of both atlases and the
    Adam moments of its band alone; the decoders are replicated;
  * one halo-exchanged quad pack per atlas per loss evaluation, cast to
    bfloat16 under ``mapping.map_bf16``;
  * every query samples the rank's own rows (banded K1) and sums the
    partial features over the ranks (``features``); the decoders and the
    loss then run replicated on every rank, with the same rays;
  * the backward scatters each rank's atlas gradient into its own band
    (banded K2) and sums the coordinate gradient (``coord_grad``).

``ShardedMapGeometry.shard`` slices the replicated map into this rank's
bands (no collective); ``unshard`` all-gathers the bands (``bands``) into
the replicated map that tracking, meshing and checkpoints read, once per
mapped frame.
"""

from __future__ import annotations

import torch

from myslam_torch.models.decoders import decode_rgb_corners, \
    decode_sdf_corners
from myslam_torch.models.planes import MapState
from myslam_torch.parallel import distributed
from myslam_torch.parallel.plane_shard import BandedSampler, \
    ShardedPlaneLayout
from myslam_torch.render.renderer import FieldQueries, SceneGeometry, \
    _row_map


class ShardedMapGeometry:
    """This rank's geometry of a band-sharded map over the current
    group's ``n_shards`` ranks (rank d holds shard d): the sharded
    layouts, the samplers and the shard/unshard index maps.

    ``quad_dtype`` (``mapping.map_bf16``): the banded quads' read
    precision; the band atlases, the Adam moments and the loss stay
    float32."""

    def __init__(self, scene: SceneGeometry, n_shards: int, rank: int,
                 quad_dtype=None):
        self.scene = scene
        self.n_shards = int(n_shards)
        self.rank = int(rank)
        self.quad_dtype = quad_dtype
        self.slayout_sdf = ShardedPlaneLayout(scene.sdf_layout, n_shards)
        self.slayout_color = ShardedPlaneLayout(scene.color_layout, n_shards)
        self.sdf = BandedSampler(self.slayout_sdf, rank)
        self.color = BandedSampler(self.slayout_color, rank)
        self._index = {}

    def _maps(self, slayout: ShardedPlaneLayout, device):
        """(this rank's band rows -> standard rows, -1 for padding;
        standard rows -> rows of the gathered bands), on ``device``."""
        key = (id(slayout), str(device))
        if key not in self._index:
            n = slayout.local_rows
            to_std = slayout.to_banded_index()[self.rank * n:
                                               (self.rank + 1) * n]
            self._index[key] = (torch.as_tensor(to_std).to(device),
                                torch.as_tensor(
                                    slayout.from_banded_index()).to(device))
        return self._index[key]

    def _band(self, atlas: torch.Tensor, slayout) -> torch.Tensor:
        to_std, _ = self._maps(slayout, atlas.device)
        rows = atlas.detach()[torch.clamp(to_std, min=0)]
        return torch.where(to_std[:, None] >= 0, rows,
                           torch.zeros_like(rows))

    def shard(self, ms: MapState) -> MapState:
        """This rank's banded map: its band of each atlas (new leaf
        tensors; padding rows 0) and the replicated map's decoder module
        itself."""
        return MapState(
            sdf_atlas=self._band(ms.sdf_atlas,
                                 self.slayout_sdf).requires_grad_(),
            color_atlas=self._band(ms.color_atlas,
                                   self.slayout_color).requires_grad_(),
            decoder=ms.decoder)

    def _gather(self, band: torch.Tensor, slayout) -> torch.Tensor:
        _, from_std = self._maps(slayout, band.device)
        parts = distributed.all_gather(band.detach(), "bands")
        return parts.reshape(-1, band.shape[-1])[from_std]

    @torch.no_grad()
    def unshard(self, banded: MapState, into: MapState) -> MapState:
        """Write the ranks' bands, all-gathered, into the replicated map
        ``into`` in place (its decoder is the banded map's); returns
        it."""
        into.sdf_atlas.copy_(self._gather(banded.sdf_atlas,
                                          self.slayout_sdf))
        into.color_atlas.copy_(self._gather(banded.color_atlas,
                                            self.slayout_color))
        return into

    def queries_factory(self, ms: MapState) -> FieldQueries:
        """FieldQueries over a banded map: each atlas's halo-exchanged
        quads packed once here, every query of the loss reusing them."""
        scene = self.scene
        sdf_quad = self.sdf.pack(ms.sdf_atlas)
        color_quad = self.color.pack(ms.color_atlas)
        if self.quad_dtype is not None:
            sdf_quad = sdf_quad.to(self.quad_dtype)
            color_quad = color_quad.to(self.quad_dtype)
        dev = sdf_quad.device
        rm_sdf = _row_map(scene.sdf_layout, dev)
        rm_color = _row_map(scene.color_layout, dev)
        dec = ms.decoder

        def sdf(p):
            return decode_sdf_corners(dec, self.sdf.sample(sdf_quad, p),
                                      rm_sdf)

        def rgb(p):
            return decode_rgb_corners(dec, self.color.sample(color_quad, p),
                                      rm_color)

        def sdf_ng(p):
            with torch.no_grad():
                return sdf(p)

        return FieldQueries(sdf=sdf, rgb=rgb, sdf_ng=sdf_ng,
                            beta=dec.beta[0], beta_ng=dec.beta[0].detach())

