"""Keyframe stores (fixed-capacity slot buffers) and window selection.

Imagery lives in pre-allocated tensors indexed by keyframe slot; the
frustum-overlap scores of all slots come from one batched computation
with inactive slots masked, and the window is assembled on the device
without a host round-trip.

The store modes of ``myslam_tpu.engine.keyframes.KeyframeStore``, picked
by the config's ``keyframe_device`` (``store_mode``):

  * ``device``: color float16 and depth float32 on the device;
  * ``packed`` (``cpu``): the frame packet's wire format on the device,
    color uint8 and depth uint16 with a float32 scale per slot, half the
    bytes; the mapper dequantizes only the pixels it samples;
  * ``host_staged`` (``host``): the wire format in host memory, behind a
    device line cache that holds the BA window (``stage_lines``).

Poses always stay on the device.

A store sharded over the ranks of a process group (``shard=(rank, n)``,
keyframe-sharded BA, ``parallel/distributed_ba.py``) holds on each rank
only the imagery of its own contiguous block of ``capacity / n`` slots;
the poses and the bookkeeping stay whole on every rank, and
``full_view()`` gathers the imagery to rank 0 for a checkpoint or a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from myslam_torch.core.geometry import invert_pose, project_points, \
    rays_from_uv
from myslam_torch.core.sampling import gather_pixels, sample_pixels, \
    unit_linspace
from myslam_torch.engine.camera import Camera


def store_mode(keyframe_device) -> str:
    """The store mode a ``keyframe_device`` value picks, as the JAX
    package's scheduler maps it: ``host``/``host_staged`` give the
    host-staged store, ``cpu``/``packed`` the packed store, anything else
    (``tpu``, the default, and ``device``) the float store."""
    mode = str(keyframe_device).lower()
    if mode in ("host", "host_staged"):
        return "host_staged"
    if mode in ("cpu", "packed"):
        return "packed"
    return "device"


class KeyframeStore:
    """Fixed-capacity keyframe imagery and poses.

    The last slot (``capacity - 1``) is the mapper's scratch slot for the
    current frame.  Buffers are updated in place.  ``device`` is where
    the poses and the device imagery live; ``mode`` is one of
    ``store_mode``'s values:

      * ``device``: ``colors`` (cap, H, W, 3) ``color_dtype``, ``depths``
        (cap, H, W) float32;
      * ``packed``: ``colors`` uint8, ``depths_u16`` uint16 and
        ``depth_inv_q`` (cap,) float32, the halves of the JAX store's
        ``depths`` pair ``(u16, inv_q)``;
      * ``host_staged``: ``colors_u8``, ``depths_u16`` and
        ``depth_inv_q`` on the host (pinned when ``device`` is a GPU),
        and after ``init_cache`` the device line cache.
    """

    def __init__(self, capacity: int, cam: Camera, device,
                 color_dtype=torch.float16, mode: str = "device",
                 shard: tuple[int, int] | None = None):
        if mode not in ("device", "packed", "host_staged"):
            raise ValueError(f"unknown keyframe store mode {mode!r}")
        self.capacity = int(capacity)
        # Sharded: this rank's imagery rows are global slots
        # [slot_offset, slot_offset + local_capacity).
        self.shard = shard
        self.local_capacity = self.capacity
        self.slot_offset = 0
        if shard is not None:
            rank, n = shard
            if mode == "host_staged" or self.capacity % n:
                raise ValueError(
                    f"a store sharded {n} ways needs a device or packed "
                    f"store whose capacity ({capacity}) divides by {n}")
            self.local_capacity = self.capacity // n
            self.slot_offset = rank * self.local_capacity
        # The ranks whose slots make the whole store (full_view's
        # gather), None: every rank (``distributed.Group``).
        self.gather_group = None
        self.cam = cam
        self.device = torch.device(device)
        self.mode = mode
        self.packed = mode == "packed"
        self.host_mode = mode == "host_staged"
        self.count = 0
        # Whether each slot's depth map has holes: lets the mapper skip
        # the depth-less sampling branch when no frame has any.
        self.has_depthless: list[bool] = [False] * self.capacity
        # Frame index of each admitted keyframe, by slot.
        self.frame_ids: list[int] = []
        rows = self.local_capacity
        img, px = (rows, cam.H, cam.W, 3), (rows, cam.H, cam.W)
        if self.host_mode:
            pin = self.device.type == "cuda"
            self.colors_u8 = torch.zeros(img, dtype=torch.uint8,
                                         pin_memory=pin)
            self.depths_u16 = torch.zeros(px, dtype=torch.uint16,
                                          pin_memory=pin)
            self.depth_inv_q = torch.ones((capacity,), dtype=torch.float32)
        elif self.packed:
            self.colors = torch.zeros(img, dtype=torch.uint8,
                                      device=device)
            self.depths_u16 = torch.zeros(px, dtype=torch.uint16,
                                          device=device)
            self.depth_inv_q = torch.ones((rows,), dtype=torch.float32,
                                          device=device)
        else:
            self.colors = torch.zeros(img, dtype=color_dtype, device=device)
            self.depths = torch.zeros(px, dtype=torch.float32,
                                      device=device)
        eye = torch.eye(4, device=device)
        self.est_c2w = eye.repeat(capacity, 1, 1)
        self.gt_c2w = eye.repeat(capacity, 1, 1)

    def local_slot(self, slot: int) -> int | None:
        """The row of global ``slot`` in this rank's imagery, or None
        when another rank holds it."""
        row = int(slot) - self.slot_offset
        return row if 0 <= row < self.local_capacity else None

    def write_packet(self, slot: int, color_u8, depth_u16,
                     inv_q: float) -> None:
        """A frame packet's imagery (uint8 color, uint16 depth and its
        scale) into global ``slot``, on the rank that holds it: as it
        comes for the packed store, dequantized for the float store."""
        row = self.local_slot(slot)
        if row is None:
            return
        if self.packed:
            self.colors[row] = color_u8
            self.depths_u16[row] = depth_u16
            self.depth_inv_q[row] = inv_q
        else:
            self.colors[row] = (color_u8.to(torch.float32)
                                * (1.0 / 255.0)).to(self.colors.dtype)
            self.depths[row] = depth_u16.to(torch.float32) * inv_q

    def imagery(self) -> tuple:
        """This rank's imagery buffers: (colors, depths, None) for the
        float store, (colors, depths_u16, depth_inv_q) for the packed."""
        if self.packed:
            return self.colors, self.depths_u16, self.depth_inv_q
        return self.colors, self.depths, None

    def full_view(self) -> "KeyframeStore | None":
        """The store with every slot's imagery, on rank 0: itself when
        unsharded; for a sharded store an unsharded copy on rank 0, its
        imagery gathered from the ranks in one collective per buffer, and
        None on the other ranks, which allocate no copy (every rank must
        call this at the same point).  With a ``gather_group`` (kf x dp:
        the column holding each kf row once) its ranks gather."""
        if self.shard is None:
            return self
        from myslam_torch.parallel import distributed

        group = self.gather_group
        if group is not None and not group.member:
            return None
        with distributed.scope(group):
            parts = [distributed.gather_to_rank0(src, "store")
                     if src is not None else None
                     for src in self.imagery()]
            if distributed.rank() != 0:
                return None
        full = KeyframeStore(self.capacity, self.cam, self.device,
                             mode=self.mode,
                             color_dtype=(self.colors.dtype if not
                                          self.packed else torch.float16))
        rows = self.local_capacity
        with torch.no_grad():
            for dst, gathered in zip(full.imagery(), parts):
                for r, part in enumerate(gathered or ()):
                    dst[r * rows:(r + 1) * rows].copy_(part)
            full.est_c2w.copy_(self.est_c2w)
            full.gt_c2w.copy_(self.gt_c2w)
        full.count = self.count
        full.has_depthless = list(self.has_depthless)
        full.frame_ids = list(self.frame_ids)
        return full

    def imagery_bytes(self) -> int:
        """Bytes of the store's imagery on the device (color and depth
        maps; the host store's line cache once it exists)."""
        if self.host_mode:
            if not hasattr(self, "cache_colors"):
                return 0
            bufs = (self.cache_colors, self.cache_depths)
        else:
            bufs = (self.colors,
                    self.depths_u16 if self.packed else self.depths)
        return sum(b.numel() * b.element_size() for b in bufs)

    def wire(self) -> tuple:
        """The wire-format buffers of a packed or host-staged store:
        color uint8 (cap, H, W, 3), depth uint16 (cap, H, W) and
        ``depth_inv_q`` float32 (cap,)."""
        if self.mode == "device":
            raise ValueError("the float store holds no wire format")
        colors = self.colors_u8 if self.host_mode else self.colors
        return colors, self.depths_u16, self.depth_inv_q

    def depths_float(self) -> torch.Tensor:
        """Depth maps (cap, H, W) as float32 (dequantized for the packed
        store)."""
        if self.host_mode:
            raise ValueError("the host-staged store's depths are on the "
                             "host: read depths_u16 and depth_inv_q")
        if self.packed:
            return (self.depths_u16.to(torch.float32)
                    * self.depth_inv_q[:, None, None])
        return self.depths

    def note_admitted(self, has_depthless: bool, frame_id: int) -> int:
        """Record a keyframe of frame ``frame_id`` that the mapper just
        wrote at slot ``count``."""
        if self.count >= self.capacity - 1:
            raise RuntimeError("keyframe store full")
        pos = self.count
        self.has_depthless[pos] = bool(has_depthless)
        self.frame_ids.append(int(frame_id))
        self.count += 1
        return pos

    # -- host_staged: the host arrays ------------------------------------

    def add_host(self, frame_id: int, color_u8, depth_u16, inv_q: float,
                 has_depthless: bool = True) -> int:
        """Admit a keyframe's wire-format imagery (numpy or CPU tensors)
        into the host store at slot ``count`` (its poses are written on
        the device by the window mapper)."""
        pos = self.count
        self.note_admitted(has_depthless, frame_id)
        self.colors_u8[pos] = torch.as_tensor(color_u8)
        self.depths_u16[pos] = torch.as_tensor(depth_u16)
        self.depth_inv_q[pos] = float(inv_q)
        return pos

    def window_imagery(self, slots) -> tuple:
        """The host imagery of the given global slots, stacked (color
        uint8, depth uint16, inv_q float32)."""
        idx = torch.as_tensor(np.asarray(slots, np.int64))
        return (self.colors_u8[idx], self.depths_u16[idx],
                self.depth_inv_q[idx])

    # -- host_staged: the device line cache --------------------------------
    #
    # The window's slots barely change between consecutive mapped frames,
    # so a small slab of wire-format imagery "lines" on the device acts
    # as a cache: the mapper reads pixels straight from the slab (the
    # packed store's gather) and only slots not already resident are
    # uploaded.  Line ``lines - 1`` is the scratch line for the current
    # frame; admission binds the scratch line's contents to a permanent
    # line with a device-side copy.

    def init_cache(self, lines: int) -> None:
        if not self.host_mode:
            raise ValueError("only the host-staged store has a line cache")
        lines = int(lines)
        H, W = self.cam.H, self.cam.W
        self.cache_lines = lines
        self.scratch_line = lines - 1
        self.cache_colors = torch.zeros((lines, H, W, 3), dtype=torch.uint8,
                                        device=self.device)
        self.cache_depths = torch.zeros((lines, H, W), dtype=torch.uint16,
                                        device=self.device)
        self.cache_inv_q = torch.ones((lines,), dtype=torch.float32,
                                      device=self.device)
        self.line_of_slot = np.full((self.capacity,), -1, np.int32)
        self.slot_of_line = np.full((lines,), -1, np.int32)
        self._line_tick = np.zeros((lines,), np.int64)
        self._line_tick[self.scratch_line] = np.iinfo(np.int64).max
        self._tick = 0
        self.cache_misses = 0

    def _write_line(self, line: int, color_u8, depth_u16, inv_q) -> None:
        """Upload one frame's imagery into cache line ``line``.  The
        copies do not wait for the device: a pinned source is a host
        store slot, which is written once before its first upload, and
        CUDA copies a pageable one to staging memory before the call
        returns."""
        self.cache_colors[line].copy_(torch.as_tensor(color_u8),
                                      non_blocking=True)
        self.cache_depths[line].copy_(torch.as_tensor(depth_u16),
                                      non_blocking=True)
        self.cache_inv_q[line] = float(inv_q)

    def stage_scratch(self, color_u8, depth_u16, inv_q) -> int:
        """Upload the current frame's packet into the scratch line."""
        self._write_line(self.scratch_line, color_u8, depth_u16, inv_q)
        return self.scratch_line

    def _lru_victim(self) -> int:
        ln = int(np.argmin(self._line_tick))
        if self._line_tick[ln] >= self._tick:
            raise RuntimeError(
                "host_staged cache smaller than the BA window; raise "
                "mapping.host_cache_lines")
        old = self.slot_of_line[ln]
        if old >= 0:
            self.line_of_slot[old] = -1
        return ln

    def stage_lines(self, slots) -> np.ndarray:
        """Make the given global slots cache-resident (uploading only the
        missing ones), pin them for this window, and return their line
        ids."""
        slots = np.asarray(slots, np.int64)
        self._tick += 1
        t = self._tick
        for s in slots:  # pin residents first: they can't become victims
            ln = self.line_of_slot[s]
            if ln >= 0:
                self._line_tick[ln] = t
        lines = np.empty(len(slots), np.int32)
        for k, s in enumerate(slots):
            ln = int(self.line_of_slot[s])
            if ln < 0:
                ln = self._lru_victim()
                self._write_line(ln, self.colors_u8[s], self.depths_u16[s],
                                 self.depth_inv_q[s])
                self.line_of_slot[s] = ln
                self.slot_of_line[ln] = s
                self._line_tick[ln] = t
                self.cache_misses += 1
            lines[k] = ln
        return lines

    def check_cache(self) -> int:
        """Every cache line bound to a slot holds that slot's host
        imagery byte for byte, and the slot maps back to it; returns the
        count of bound lines (raises AssertionError on a mismatch)."""
        bound = 0
        for ln, s in enumerate(self.slot_of_line):
            if s < 0:
                continue
            same = (self.line_of_slot[s] == ln
                    and torch.equal(self.cache_colors[ln].cpu(),
                                    self.colors_u8[s])
                    and torch.equal(self.cache_depths[ln].cpu(),
                                    self.depths_u16[s])
                    and float(self.cache_inv_q[ln]) == float(
                        self.depth_inv_q[s]))
            if not same:
                raise AssertionError(f"cache line {ln} does not hold slot "
                                     f"{s}")
            bound += 1
        return bound

    def bind_scratch(self, slot: int) -> None:
        """Admit the scratch line's imagery as keyframe ``slot``'s cache
        entry (device-side copy, no re-upload at the next selection).

        Prefers a never-assigned line: _lru_victim runs after the tick
        bump, so at or near the minimum cache size it could otherwise
        evict a line stage_lines just pinned for the current window,
        forcing a re-upload of that slot on the next mapped frame."""
        self._tick += 1
        free = np.nonzero(self.slot_of_line < 0)[0]
        free = free[free != self.scratch_line]
        ln = int(free[0]) if len(free) else self._lru_victim()
        sl = self.scratch_line
        self.cache_colors[ln] = self.cache_colors[sl]
        self.cache_depths[ln] = self.cache_depths[sl]
        self.cache_inv_q[ln] = self.cache_inv_q[sl]
        self.line_of_slot[slot] = ln
        self.slot_of_line[ln] = slot
        self._line_tick[ln] = self._tick


def make_overlap_scorer(cam: Camera, num_rays: int = 50,
                        num_samples: int = 8, edge: int = 20):
    """Frustum-overlap scores of the current frame against all slots.

    Returns score(kf_c2w (cap, 4, 4), n_scored, cur_c2w, gt_depth, draws)
    -> (cap,) fraction of the current frame's surface samples inside each
    keyframe's frustum; -1 for slots >= n_scored.  Draws: the pixel pick
    (``sample_pixels``).
    """

    def score(kf_c2w, n_scored, cur_c2w, gt_depth, draws):
        i, j = sample_pixels(draws, num_rays, 0, cam.H, 0, cam.W)
        d = gather_pixels(gt_depth, i, j)
        rays_o, rays_d = rays_from_uv(i, j, cur_c2w, cam.fx, cam.fy, cam.cx,
                                      cam.cy)
        valid = d > 0
        t_vals = unit_linspace(num_samples, d.device)
        near = 0.8 * d[:, None]
        far = d[:, None] + 0.5
        z = near * (1 - t_vals)[None, :] + far * t_vals[None, :]
        pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
               ).reshape(-1, 3)
        pt_valid = valid.repeat_interleave(num_samples)
        w2cs = invert_pose(kf_c2w)
        u, v, zc = project_points(pts[None, :, :], w2cs[:, None, :, :],
                                  cam.fx, cam.fy, cam.cx, cam.cy)
        inside = ((u < cam.W - edge) & (u > edge) & (v < cam.H - edge)
                  & (v > edge) & (zc < 0) & pt_valid[None, :])
        n_valid = torch.clamp(pt_valid.sum(), min=1)
        pct = inside.sum(dim=1) / n_valid
        slot_ids = torch.arange(kf_c2w.shape[0], device=kf_c2w.device)
        return torch.where(slot_ids < n_scored, pct.to(torch.float32),
                           torch.full_like(pct, -1.0, dtype=torch.float32))

    return score


def make_window_selector(cam: Camera, capacity: int, window_size: int,
                         w_max: int, scratch_slot: int,
                         method: str = "overlap", num_rays: int = 50,
                         num_samples: int = 8, edge: int = 20):
    """Device-side BA-window selection.

    Up to window_size-1 picks, uniformly at random without replacement,
    from the keyframes older than the last two that overlap the current
    frame (``method="overlap"``) or from all of them (``"global"``), plus
    the last two, ascending; then the scratch slot for the current frame.

    Returns select(kf_c2w, count, cur_c2w, gt_depth, draws, joint_opt)
      -> (slot_kf (w_max,) int64: window slots ascending then the scratch
          slot, padded with 0; n_slots (0-dim int64); pose_mask (w_max,)
          float32, 1 for the optimized poses).
    Draws, in order: the scorer's pixel pick (``"overlap"`` only), then
    ``uniform((capacity,))`` for the random subset.
    """
    scorer = make_overlap_scorer(cam, num_rays, num_samples, edge)

    def select(kf_c2w, count: int, cur_c2w, gt_depth, draws, joint_opt):
        dev = kf_c2w.device
        slot_ids = torch.arange(capacity, device=dev)
        if method == "overlap":
            scores = scorer(kf_c2w, count - 2, cur_c2w, gt_depth, draws)
            eligible = scores > 0  # already -1 for slots >= count-2
        else:
            eligible = slot_ids < count - 2
        r = draws.uniform((capacity,))
        rank = torch.where(eligible, r, torch.full_like(r, -float("inf")))
        k = min(window_size - 1, capacity)
        top_idx = torch.topk(rank, k).indices
        chosen = torch.zeros((capacity,), dtype=torch.bool, device=dev)
        chosen[top_idx] = eligible[top_idx]
        if count > 1:  # the last two keyframes always join
            chosen[count - 2:count] = True
        n_kf = chosen.sum()
        # Chosen slots ascending, padded to w_max with 0 (no host sync).
        key = torch.where(chosen, slot_ids, torch.full_like(slot_ids,
                                                            capacity))
        ordered = torch.sort(key).values
        if ordered.numel() < w_max:
            ordered = torch.cat([ordered, ordered.new_full(
                (w_max - ordered.numel(),), capacity)])
        ordered = ordered[:w_max]
        ordered = torch.where(ordered == capacity, 0, ordered)
        pos = torch.arange(w_max, device=dev)
        slot_kf = torch.where(pos == n_kf, scratch_slot, ordered)
        pose_mask = ((pos >= 1) & (pos <= n_kf)).to(torch.float32) * float(
            joint_opt)
        return slot_kf, n_kf + 1, pose_mask

    return select


def select_window(rng: np.random.Generator, scorer, store: KeyframeStore,
                  cur_c2w: torch.Tensor, gt_depth: torch.Tensor,
                  window_size: int, draws,
                  method: str = "overlap") -> list[int]:
    """Keyframe slots for the BA window (current frame excluded), chosen
    on the host with a numpy Generator.

    Up to window_size-1 slots drawn from the keyframes older than the
    last two (those overlapping the current frame by ``scorer``, or all
    of them), plus the last two keyframes, ascending.  Draws: the
    scorer's (``"overlap"`` with more than two keyframes only).
    """
    n = store.count
    if n == 0:
        return []
    picked: list[int] = []
    if n > 2:
        if method == "overlap":
            scores = scorer(store.est_c2w, n - 2, cur_c2w, gt_depth,
                            draws).cpu().numpy()
            eligible = np.nonzero(scores[:n - 2] > 0)[0]
        else:
            eligible = np.arange(max(n - 2, 0))
        perm = rng.permutation(len(eligible))
        picked = [int(eligible[p]) for p in perm[:window_size - 1]]
    if n > 1:
        picked = sorted(picked + [n - 1, n - 2])
    return picked
