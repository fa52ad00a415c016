"""Ray/pixel sampling: stratified + depth-guided z values, CDF inversion.

Every sampler takes its random numbers from a *draw source*, an object
with ``uniform(shape)`` and ``randint(shape, low, high)``:

  * ``TorchDraws`` wraps one ``torch.Generator`` on the device, seeded
    once per run (the default);
  * ``ReplayDraws`` hands out a fixed list of draws in call order, so a
    test can feed the port exactly the numbers the JAX package drew;
  * ``RowShardDraws`` gives one rank its rows of a batch's draws, and
    ``RecordedDraws`` keeps draws to hand them out again.

The call order of every sampler is part of its contract (documented per
function), because a replay source is consumed in that order.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch


class TorchDraws:
    """Draws from one seeded ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def uniform(self, shape) -> torch.Tensor:
        """float32 U[0, 1) of ``shape``."""
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device)

    def randint(self, shape, low: int, high: int) -> torch.Tensor:
        """int64 uniform in [low, high) of ``shape``."""
        return torch.randint(int(low), int(high), tuple(shape),
                             generator=self.generator, device=self.device)


class ReplayDraws:
    """Replays a fixed sequence of draws, one array per sampler call.

    Each call pops the next array and checks it against the requested
    shape (and, for ``randint``, range), so a replay that drifts out of
    step with the sampler's call order fails loudly.
    """

    def __init__(self, draws):
        self._queue = deque(d if isinstance(d, torch.Tensor)
                            else np.asarray(d) for d in draws)

    def __len__(self) -> int:
        return len(self._queue)

    def _next(self, shape) -> np.ndarray:
        if not self._queue:
            raise RuntimeError("replay draw source is exhausted")
        a = self._queue.popleft()
        if tuple(a.shape) != tuple(shape):
            raise ValueError(
                f"replayed draw has shape {a.shape}, sampler asked for "
                f"{tuple(shape)}")
        return a

    def uniform(self, shape) -> torch.Tensor:
        a = self._next(shape)
        if isinstance(a, torch.Tensor):
            return a
        return torch.as_tensor(a.astype(np.float32))

    def randint(self, shape, low: int, high: int) -> torch.Tensor:
        a = self._next(shape)
        if isinstance(a, torch.Tensor):
            return a
        if a.size and (a.min() < low or a.max() >= high):
            raise ValueError(f"replayed randint outside [{low}, {high})")
        return torch.as_tensor(a.astype(np.int64))


class RowShardDraws:
    """One rank's rows of another source's draws.

    A sampler asking for ``(rows, ...)`` with ``rows`` this rank's share
    of an ``n_global``-row batch (``ceil(n_global / world)``) gets rows
    ``[rank * rows, (rank + 1) * rows)`` of the base source's draw of
    ``(n_global, ...)``, zero-padded past ``n_global``: every rank
    consumes the base source exactly as the unsharded batch would, so the
    ranks together see the single-device draws."""

    def __init__(self, base, n_global: int, rank: int, world: int):
        self.base = base
        self.n_global = int(n_global)
        self.rows = -(-self.n_global // world)
        self.rank = int(rank)

    def _slice(self, full: torch.Tensor) -> torch.Tensor:
        return rank_rows(full, self.rows, self.rank)

    def _global(self, shape) -> tuple:
        shape = tuple(shape)
        if not shape or shape[0] != self.rows:
            raise ValueError(f"sharded draw of shape {shape}; rows per "
                             f"rank are {self.rows}")
        return (self.n_global,) + shape[1:]

    def uniform(self, shape) -> torch.Tensor:
        return self._slice(self.base.uniform(self._global(shape)))

    def randint(self, shape, low: int, high: int) -> torch.Tensor:
        return self._slice(self.base.randint(self._global(shape), low, high))


def rank_rows(x: torch.Tensor, rows: int, rank: int) -> torch.Tensor:
    """Rows [rank * rows, (rank + 1) * rows) of x, zero-padded past its
    end: one rank's share of a batch split over the ranks."""
    part = x[rank * rows:(rank + 1) * rows]
    if part.shape[0] < rows:
        part = torch.cat([part, part.new_zeros(
            (rows - part.shape[0],) + tuple(x.shape[1:]))])
    return part


class RecordedDraws:
    """Passes another source's draws through and keeps them;
    ``replay()`` hands the same tensors out again in the same order (a
    computation that must see the draws of an earlier one)."""

    def __init__(self, base):
        self.base = base
        self.kept: list = []

    def uniform(self, shape) -> torch.Tensor:
        self.kept.append(self.base.uniform(shape))
        return self.kept[-1]

    def randint(self, shape, low: int, high: int) -> torch.Tensor:
        self.kept.append(self.base.randint(shape, low, high))
        return self.kept[-1]

    def replay(self) -> "ReplayDraws":
        return ReplayDraws(self.kept)


def unit_linspace(n: int, device) -> torch.Tensor:
    """n points evenly spaced on [0, 1], both ends exact: i * (1/(n-1))
    for i < n-1, then 1.  Reproduces XLA's float32 ``linspace(0, 1, n)``
    bit for bit (torch.linspace rounds some interior points the other
    way)."""
    if n == 1:
        return torch.zeros(1, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) * (
        1.0 / (n - 1))
    return torch.cat([t, torch.ones(1, device=device)])


def perturb_z_vals(draws, z_vals: torch.Tensor) -> torch.Tensor:
    """Stratified jitter within inter-sample intervals.  Draws: one
    ``uniform(z_vals.shape)``."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    t_rand = draws.uniform(z_vals.shape)
    return lower + (upper - lower) * t_rand


def depth_guided_z_vals(draws, gt_depth: torch.Tensor, truncation: float,
                        n_stratified: int, n_importance: int,
                        perturb: bool) -> torch.Tensor:
    """Per-ray z values for rays with depth, (N, n_stratified+n_importance).

    n_importance surface samples in [d - 1.5 trunc, d + 1.5 trunc] plus
    n_stratified free-space samples in [0, 1.2 d], sorted, then jittered
    when ``perturb`` (one ``uniform`` draw).
    """
    dev = gt_depth.device
    t_surf = unit_linspace(n_importance, dev)
    t_uni = unit_linspace(n_stratified, dev)
    d = gt_depth[:, None]
    z_surface = d - 1.5 * truncation + 3.0 * truncation * t_surf[None, :]
    z_free = 1.2 * d * t_uni[None, :]
    z = torch.sort(torch.cat([z_free, z_surface], dim=-1), dim=-1).values
    if perturb:
        z = perturb_z_vals(draws, z)
    return z


def uniform_z_vals(draws, far: torch.Tensor, n_stratified: int,
                   perturb: bool, near: float = 0.0) -> torch.Tensor:
    """Uniform z from near to per-ray far, (N, n_stratified); jittered
    when ``perturb`` (one ``uniform`` draw)."""
    t_uni = unit_linspace(n_stratified, far.device)
    z = near * (1.0 - t_uni)[None, :] + far[:, None] * t_uni[None, :]
    if perturb:
        z = perturb_z_vals(draws, z)
    return z


def sample_pdf(draws, bins: torch.Tensor, weights: torch.Tensor,
               n_samples: int, det: bool = False,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF importance sampling, (N, n_samples).

    Keeps the reference's quirk of NOT normalizing the pdf (the raw
    weights are accumulated), so the cdf may end away from 1; uniforms
    beyond the last cdf value land in the last bin.  bins (N, M+1),
    weights (N, M).  Draws: one ``uniform((N, n_samples))`` unless ``det``
    or ``u`` is given.
    """
    cdf = torch.cumsum(weights, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    if u is None:
        shape = cdf.shape[:-1] + (n_samples,)
        if det:
            u = unit_linspace(n_samples, cdf.device).expand(shape)
        else:
            u = draws.uniform(shape)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sample_pixels(draws, n: int, h0: int, h1: int, w0: int, w1: int):
    """n uniform pixel coords (i=col, j=row) from [h0,h1) x [w0,w1), as
    float32 (n,) each.  Draws: ``randint`` for j, then for i."""
    j = draws.randint((n,), h0, h1).to(torch.float32)
    i = draws.randint((n,), w0, w1).to(torch.float32)
    return i, j


def gather_pixels(image: torch.Tensor, i: torch.Tensor, j: torch.Tensor):
    """Image values at integer pixel coords; image (H, W) or (H, W, C)."""
    return image[j.long(), i.long()]
