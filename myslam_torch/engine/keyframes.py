"""Keyframe store (fixed-capacity device buffers) and window selection.

Imagery lives in pre-allocated device tensors indexed by keyframe slot
(color float16, depth float32); the frustum-overlap scores of all slots
come from one batched computation with inactive slots masked, and the
window is assembled on the device without a host round-trip.

Only the device-resident store of ``myslam_tpu.engine.keyframes`` is
ported; its packed (u8/u16) and host-staged modes are not.
"""

from __future__ import annotations

import torch

from myslam_torch.core.geometry import invert_pose, project_points, \
    rays_from_uv
from myslam_torch.core.sampling import gather_pixels, sample_pixels, \
    unit_linspace
from myslam_torch.engine.camera import Camera


class KeyframeStore:
    """Fixed-capacity keyframe imagery and poses on one device.

    The last slot (``capacity - 1``) is the mapper's scratch slot for the
    current frame.  Buffers are updated in place.
    """

    def __init__(self, capacity: int, cam: Camera, device,
                 color_dtype=torch.float16):
        self.capacity = int(capacity)
        self.cam = cam
        self.count = 0
        # Whether each slot's depth map has holes: lets the mapper skip
        # the depth-less sampling branch when no frame has any.
        self.has_depthless: list[bool] = [False] * self.capacity
        # Frame index of each admitted keyframe, by slot.
        self.frame_ids: list[int] = []
        self.colors = torch.zeros((capacity, cam.H, cam.W, 3),
                                  dtype=color_dtype, device=device)
        self.depths = torch.zeros((capacity, cam.H, cam.W),
                                  dtype=torch.float32, device=device)
        eye = torch.eye(4, device=device)
        self.est_c2w = eye.repeat(capacity, 1, 1)
        self.gt_c2w = eye.repeat(capacity, 1, 1)

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
