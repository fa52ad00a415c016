"""Banded map shards: every plane's rows split over the ranks, with a
one-row halo exchange.

The port of ``myslam_tpu/parallel/plane_shard.py``:

  * each plane's rows (its H, padded to a multiple of the rank count)
    split evenly over the ranks: rank d holds rows [d * band_h, (d + 1) *
    band_h) of every plane at every level, concatenated in the layout's
    plane order into its band atlas (``ShardedPlaneLayout``);
  * packing the quads needs each cell's lower neighbour: each rank sends
    the first row of each of its bands to rank d - 1, whose halo it is
    (``halo``; the last rank clamps at its own last row, grid_sample's
    border padding);
  * a sample reads only the rows a rank owns (banded K1, ``ops/
    plane_sample.sample_banded``) and the partial features are summed
    over the ranks (one all-reduce of (N, L*4C) per sample call,
    ``features``).

The backward, written out because the ranks are processes:

  * the features' cotangent is the same on every rank (everything
    downstream of the sum is replicated), so the sum's backward is the
    identity, and each rank's banded K2 scatters only into its own
    band: the atlas gradient never leaves its rank;
  * the halo's gradient belongs to the next rank's first rows: the
    exchange's backward sends it there (``halo``), where it adds to the
    gradient of those rows;
  * the points are replicated, so the coordinate gradient is the sum of
    every rank's part: one all-reduce of (N, 3) per sample call
    (``coord_grad``), which the pose gradients read.

``pack_local`` and ``ops/plane_sample.sample_banded`` (the owned-row
sample, the JAX package's ``sample_local``) are the per-rank math with
the halo and the sum left to the caller (the tests run N shards in one
process with them); ``BandedSampler`` wires them to the process group.
"""

from __future__ import annotations

import numpy as np
import torch

from myslam_torch.models.planes import BandLayout, PlaneLayout
from myslam_torch.ops.plane_sample import sample_banded
from myslam_torch.parallel import distributed


class ShardedPlaneLayout:
    """Static geometry of a row-band-sharded atlas (a numpy copy of the
    JAX package's).

    For each plane (level, orientation) of shape (H, W): H is padded to
    Hp = n_shards * ceil(H / n_shards); shard d owns plane rows
    [d * Hp/n, (d+1) * Hp/n).  The local atlas concatenates each plane's
    band in the layout's plane order.
    """

    def __init__(self, layout: PlaneLayout, n_shards: int):
        self.layout = layout
        self.n_shards = int(n_shards)
        self.band_h = []      # rows of each plane per shard
        self.local_off = []   # row offset of each plane band in the shard
        self.W = []
        self.H = []
        off = 0
        for lvl in range(layout.n_levels):
            for ori in range(3):
                H, W = layout.shapes[lvl][ori]
                bh = -(-H // self.n_shards)
                self.band_h.append(bh)
                self.local_off.append(off)
                self.W.append(W)
                self.H.append(H)
                off += bh * W
        self.local_rows = off  # rows per shard

    def _planes(self):
        p = 0
        for lvl in range(self.layout.n_levels):
            for ori in range(3):
                H, W = self.layout.shapes[lvl][ori]
                yield p, H, W, self.layout.offsets[lvl][ori]
                p += 1

    def band(self, d: int) -> BandLayout:
        """Shard d's band layout (what the banded kernels take)."""
        return BandLayout(
            shapes=self.layout.shapes, local_off=tuple(self.local_off),
            y_lo=tuple(d * bh for bh in self.band_h),
            band_h=tuple(self.band_h), total_rows=self.local_rows,
            c_dim=self.layout.c_dim)

    def shard_atlas(self, atlas) -> np.ndarray:
        """(S, C) fused atlas -> (n_shards * local_rows, C) band-major
        host array, padding rows 0."""
        a = np.asarray(atlas)
        C = a.shape[-1]
        out = np.zeros((self.n_shards, self.local_rows, C), a.dtype)
        for p, H, W, off in self._planes():
            plane = a[off:off + H * W].reshape(H, W, C)
            bh = self.band_h[p]
            lo = self.local_off[p]
            for d in range(self.n_shards):
                band = plane[d * bh:(d + 1) * bh]
                out[d, lo:lo + band.shape[0] * W] = band.reshape(-1, C)
        return out.reshape(-1, C)

    def unshard_atlas(self, sharded) -> np.ndarray:
        """Inverse of shard_atlas (drops the padding rows)."""
        s = np.asarray(sharded)
        C = s.shape[-1]
        s = s.reshape(self.n_shards, self.local_rows, C)
        out = np.zeros((self.layout.total_rows, C), s.dtype)
        for p, H, W, off in self._planes():
            bh = self.band_h[p]
            lo = self.local_off[p]
            for d in range(self.n_shards):
                y0 = d * bh
                rows = min(bh, H - y0)
                if rows > 0:
                    out[off + y0 * W: off + (y0 + rows) * W] = \
                        s[d, lo:lo + rows * W]
        return out

    def to_banded_index(self) -> np.ndarray:
        """(n_shards * local_rows,) banded row -> standard atlas row, -1
        for band padding rows (never read: padded plane rows sit past the
        border clamp, and the halo weight at the true last row is 0)."""
        idx = np.full((self.n_shards, self.local_rows), -1, np.int64)
        for p, H, W, off in self._planes():
            bh = self.band_h[p]
            lo = self.local_off[p]
            for d in range(self.n_shards):
                y0 = d * bh
                rows = min(bh, H - y0)
                if rows > 0:
                    idx[d, lo:lo + rows * W] = off + np.arange(
                        y0 * W, (y0 + rows) * W)
        return idx.reshape(-1)

    def from_banded_index(self) -> np.ndarray:
        """(total_rows,) standard atlas row -> banded row (exact)."""
        fwd = self.to_banded_index()
        inv = np.zeros((self.layout.total_rows,), np.int64)
        keep = fwd >= 0
        inv[fwd[keep]] = np.nonzero(keep)[0]
        return inv


def first_rows(local: torch.Tensor, slayout: ShardedPlaneLayout
               ) -> torch.Tensor:
    """The first row of each of a shard's plane bands, stacked
    (sum of W, C): what the rank above takes as its halo."""
    return torch.cat([local[lo:lo + W] for lo, W in
                      zip(slayout.local_off, slayout.W)])


def pack_local(local: torch.Tensor, halo: torch.Tensor | None,
               slayout: ShardedPlaneLayout, last: bool) -> torch.Tensor:
    """A shard's band atlas (local_rows, C) -> its quad atlas
    (local_rows, 4C), each plane band extended by its halo row: the next
    shard's first rows (``first_rows``), or on the ``last`` shard its own
    last row (grid_sample's border clamp), selected by a where, as the
    JAX package does, so that the halo's gradient (zero there) still
    reaches the exchange.  ``halo`` None: no halo at all (one shard)."""
    C = local.shape[-1]
    parts = []
    hoff = 0
    for W, bh, lo in zip(slayout.W, slayout.band_h, slayout.local_off):
        a = local[lo:lo + bh * W].reshape(bh, W, C)
        if halo is None:
            h = a[-1:]
        else:
            h = halo[hoff:hoff + W].reshape(1, W, C)
            if last:
                h = torch.where(torch.ones((), dtype=torch.bool,
                                           device=a.device), a[-1:], h)
        hoff += W
        ext = torch.cat([a, h], dim=0)  # (bh + 1, W, C)
        right = torch.cat([ext[:, 1:], ext[:, -1:]], dim=1)
        q = torch.cat([ext[:-1], right[:-1], ext[1:], right[1:]], dim=-1)
        parts.append(q.reshape(bh * W, 4 * C))
    return torch.cat(parts, dim=0)


class _Halo(torch.autograd.Function):
    """The halo exchange: this rank's first rows to rank d - 1; returns
    the rows of rank d + 1 (zeros on the last rank).  Backward:
    the halo's gradient to rank d + 1, the gradient of this rank's first
    rows from rank d - 1."""

    @staticmethod
    def forward(ctx, rows):
        d, n = distributed.rank(), distributed.world()
        ctx.device = rows.device
        sent = (distributed.isend(rows, distributed.to_global(d - 1), "halo")
                if d > 0 else None)
        if d < n - 1:
            halo = distributed.irecv(rows.shape, rows.dtype,
                                     distributed.to_global(d + 1),
                                     "halo").wait().to(rows.device)
        else:
            halo = torch.zeros_like(rows)
        if sent is not None:
            sent.wait()
        return halo

    @staticmethod
    def backward(ctx, ghalo):
        d, n = distributed.rank(), distributed.world()
        sent = (distributed.isend(ghalo, distributed.to_global(d + 1), "halo")
                if d < n - 1 else None)
        if d > 0:
            grad = distributed.irecv(ghalo.shape, ghalo.dtype,
                                     distributed.to_global(d - 1),
                                     "halo").wait().to(ctx.device)
        else:
            grad = torch.zeros_like(ghalo)
        if sent is not None:
            sent.wait()
        return grad


class _SumRanks(torch.autograd.Function):
    """The partial features summed over the ranks (``features``).  The
    sum is replicated, so its cotangent is the same on every rank and
    the backward is the identity."""

    @staticmethod
    def forward(ctx, part):
        return distributed.all_reduce_(part.clone(), "features")

    @staticmethod
    def backward(ctx, g):
        return g


class _ReplicatedPoints(torch.autograd.Function):
    """The identity on replicated points whose backward sums the ranks'
    parts of their gradient (``coord_grad``)."""

    @staticmethod
    def forward(ctx, p_nor):
        return p_nor.view_as(p_nor)

    @staticmethod
    def backward(ctx, g):
        return distributed.all_reduce_(g.contiguous().clone(), "coord_grad")


class BandedSampler:
    """A rank's pack and sample over a band-sharded atlas, on the current
    group's ranks (rank d holds shard d).

      pack(local (local_rows, C)) -> local quad (local_rows, 4C): the
        halo exchange and the packing, once per atlas per loss;
      sample(quad, p_nor (N, 3)) -> (N, L*4C), the same on every rank:
        the owned-row sample and its sum over the ranks.
    """

    def __init__(self, slayout: ShardedPlaneLayout, d: int):
        self.slayout = slayout
        self.d = int(d)
        self.band = slayout.band(self.d)

    def pack(self, local: torch.Tensor) -> torch.Tensor:
        n = self.slayout.n_shards
        if n == 1:
            return pack_local(local, None, self.slayout, True)
        halo = _Halo.apply(first_rows(local, self.slayout))
        return pack_local(local, halo, self.slayout, self.d == n - 1)

    def sample(self, quad: torch.Tensor, p_nor: torch.Tensor
               ) -> torch.Tensor:
        if self.slayout.n_shards == 1:
            return sample_banded(quad, self.band, p_nor)
        if p_nor.requires_grad and torch.is_grad_enabled():
            p_nor = _ReplicatedPoints.apply(p_nor)
        return _SumRanks.apply(sample_banded(quad, self.band, p_nor))
