"""RGB-D frame sources and the per-frame packet.

Only the procedural ``Synthetic`` room is ported: an analytic scene
(AABB walls + spheres) with exact depth and poses, rendered in numpy.
Frames are numpy arrays (color float32 HxWx3 in [0,1], depth float32
HxW in meters, c2w 4x4); the scheduler owns the device upload.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


def get_dataset(cfg: dict):
    name = cfg["dataset"]
    if name != "synthetic":
        raise ValueError(f"dataset '{name}' is not ported to myslam_torch "
                         "(only 'synthetic')")
    return Synthetic(cfg)


class Synthetic:
    """Procedural room (AABB walls + two spheres) rendered analytically.

    cfg['data'] may set n_frames, room, spheres and ang_step; the
    intrinsics come from cfg['cam'].  Colors are smooth position-based
    patterns.
    """

    def __init__(self, cfg: dict):
        self.name = cfg["dataset"]
        cam = cfg["cam"]
        self.H, self.W = cam["H"], cam["W"]
        self.fx, self.fy = cam["fx"], cam["fy"]
        self.cx, self.cy = cam["cx"], cam["cy"]
        data = cfg.get("data", {})
        self.n_img = int(data.get("n_frames", 40))
        self.room = np.array(data.get(
            "room", [[0.0, 4.0], [0.0, 3.0], [0.0, 2.5]]))
        self.spheres = np.array(data.get(
            "spheres", [[2.6, 1.9, 0.7, 0.5], [1.3, 0.9, 1.6, 0.35]]))
        # Per-frame angular step (rad), fixed per frame so inter-frame
        # motion stays at camera-tracking magnitudes for any n_frames.
        self.ang_step = float(data.get("ang_step", 0.008))
        self.poses = [self._pose(i) for i in range(self.n_img)]
        self._dirs_cam = None

    def __len__(self):
        return self.n_img

    @property
    def frame_hw(self) -> tuple:
        return self.H, self.W

    def _pose(self, idx: int) -> np.ndarray:
        center = self.room.mean(axis=1)
        ang = -0.45 * np.pi + idx * self.ang_step
        eye = center + np.array(
            [0.9 * np.cos(ang), 0.9 * np.sin(ang), 0.25 * np.sin(2 * ang)])
        target = center + np.array(
            [1.6 * np.cos(ang + 0.9), 1.6 * np.sin(ang + 0.9), 0.1])
        return look_at(eye, target).astype(np.float32)

    def get_frame(self, index: int):
        if self._dirs_cam is None:
            j, i = np.meshgrid(np.arange(self.H, dtype=np.float32),
                               np.arange(self.W, dtype=np.float32),
                               indexing="ij")
            self._dirs_cam = np.stack(
                [(i - self.cx) / self.fx, -(j - self.cy) / self.fy,
                 -np.ones_like(i)], axis=-1)
        c2w = self.poses[index]
        color, depth = render_analytic(
            c2w, self.H, self.W, self.fx, self.fy, self.cx, self.cy,
            self.room, self.spheres, dirs_cam=self._dirs_cam)
        return (color.astype(np.float32), depth.astype(np.float32),
                c2w.astype(np.float32))

    def sample_pixels(self, index: int, i: np.ndarray, j: np.ndarray):
        """Sparse RGB-D at pixel coords: only the requested rays."""
        return render_analytic_pixels(
            self.poses[index], i, j, self.fx, self.fy, self.cx, self.cy,
            self.room, self.spheres)

    def gt_sdf(self, pts: np.ndarray) -> np.ndarray:
        """Exact signed distance of the scene surface at (..., 3) points:
        positive in free (interior) space, negative inside walls/spheres.
        The scene's surface = room-interior walls + solid spheres, so
        sdf = min(distance-to-walls-from-inside, sphere sdfs)."""
        pts = np.asarray(pts, np.float32)
        lo = self.room[:, 0].astype(np.float32)
        hi = self.room[:, 1].astype(np.float32)
        d = np.minimum(pts - lo, hi - pts).min(axis=-1)
        for sx, sy, sz, r in self.spheres:
            d = np.minimum(
                d, np.linalg.norm(
                    pts - np.array([sx, sy, sz], np.float32), axis=-1) - r)
        return d

    def save_gt_mesh(self, path: str, resolution: float = 0.01,
                     device=None) -> str:
        """Ground-truth surface mesh from the analytic SDF (evaluated on
        the host; marching tetrahedra at ``resolution`` on ``device``,
        default the GPU): the reconstruction-eval oracle that real
        datasets ship as files (reference README.md:99-118)."""
        from myslam_torch.ops.marching import extract_isosurface
        from myslam_torch.utils.ply import write_ply

        pad = 0.05
        axes = [np.arange(lo - pad, hi + pad + resolution, resolution,
                          dtype=np.float32) for lo, hi in self.room]
        g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
        vol = self.gt_sdf(g.reshape(-1, 3)).reshape(g.shape[:-1])
        del g
        verts, faces = extract_isosurface(
            vol, origin=[a[0] for a in axes], spacing=[resolution] * 3,
            # sign convention: solid where sdf < 0, same as the map's
            level=0.0, device=device)
        write_ply(path, verts, faces)
        return path


def look_at(eye: np.ndarray, target: np.ndarray,
            up=np.array([0.0, 0.0, 1.0])) -> np.ndarray:
    """c2w with the renderer's -z-forward convention."""
    f = target - eye
    f = f / np.linalg.norm(f)
    z = -f
    x = np.cross(f, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def _raycast_analytic(o, d, room, spheres):
    """Exact ray cast: o (3,), d (..., 3) float32 -> (color, t_hit).

    Depth is the t of the hit along the unnormalized direction
    [(i-cx)/fx, -(j-cy)/fy, -1], i.e. the perpendicular RGB-D depth.
    Everything stays float32.
    """
    room = room.astype(np.float32)
    base = d.shape[:-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        tt = (room.reshape((1,) * len(base) + (3, 2))
              - o.reshape((1,) * len(base) + (3, 1))) / d[..., None]
    t_hit = np.min(np.max(tt, axis=-1), axis=-1)
    obj_id = np.zeros(base, np.int32)  # 0 = wall
    for si, (sx, sy, sz, r) in enumerate(spheres):
        oc = (o - np.array([sx, sy, sz], np.float32))
        a = np.sum(d * d, axis=-1)
        b = 2.0 * (d @ oc)
        c0 = np.float32(oc @ oc - r * r)
        disc = b * b - 4 * a * c0
        valid = disc > 0
        sq = np.sqrt(np.maximum(disc, 0))
        t_s = (-b - sq) / (2 * a)
        hit = valid & (t_s > 1e-4) & (t_s < t_hit)
        t_hit = np.where(hit, t_s, t_hit)
        obj_id = np.where(hit, si + 1, obj_id)
    pts = o.reshape((1,) * len(base) + (3,)) + t_hit[..., None] * d
    phase = (np.array([0.0, 2.1, 4.2], np.float32)
             + obj_id[..., None].astype(np.float32) * 1.3)
    freq = 2.0 + 1.5 * obj_id[..., None].astype(np.float32)
    color = 0.5 + 0.35 * np.sin(
        freq * pts[..., [0, 1, 2]] + phase) + 0.15 * np.cos(
        np.float32(3.1) * pts[..., [1, 2, 0]])
    color = np.clip(color, 0.0, 1.0).astype(np.float32)
    return color, t_hit.astype(np.float32)


def render_analytic(c2w, H, W, fx, fy, cx, cy, room, spheres,
                    dirs_cam=None):
    """Exact full-image ray-cast RGB-D of the procedural scene."""
    if dirs_cam is None:
        j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                           np.arange(W, dtype=np.float32), indexing="ij")
        dirs_cam = np.stack(
            [(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], axis=-1)
    d = dirs_cam @ c2w[:3, :3].T.astype(np.float32)
    return _raycast_analytic(c2w[:3, 3].astype(np.float32), d, room, spheres)


def render_analytic_pixels(c2w, i, j, fx, fy, cx, cy, room, spheres):
    """Ray-cast only the pixel coordinates i (N,), j (N,)."""
    i = i.astype(np.float32)
    j = j.astype(np.float32)
    dirs_cam = np.stack(
        [(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], axis=-1)
    d = dirs_cam @ c2w[:3, :3].T.astype(np.float32)
    return _raycast_analytic(c2w[:3, 3].astype(np.float32), d, room, spheres)


class FramePacket:
    """What the device consumes of one frame.

      * tracking pixels: ``iters`` fresh batches of ``n_px`` pixels, drawn
        on the host, as (iters, n_px) arrays;
      * full imagery (color uint8, depth uint16 + dequantization scale)
        only for frames that enter the keyframe store / mapping.
    """

    __slots__ = ("idx", "gt_c2w", "px_i", "px_j", "px_color", "px_depth",
                 "color_u8", "depth_u16", "depth_inv_q", "has_depthless")

    def __init__(self, idx, gt_c2w, px_i, px_j, px_color, px_depth,
                 color_u8=None, depth_u16=None, depth_inv_q=0.0,
                 has_depthless=True):
        self.idx = idx
        self.gt_c2w = gt_c2w
        self.px_i = px_i
        self.px_j = px_j
        self.px_color = px_color
        self.px_depth = px_depth
        self.color_u8 = color_u8
        self.depth_u16 = depth_u16
        self.depth_inv_q = depth_inv_q
        self.has_depthless = has_depthless


def _encode_color_u8(color: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(color * 255.0), 0, 255).astype(np.uint8)


def build_packet(dataset, idx: int, *, iters: int, n_px: int, ie_h: int,
                 ie_w: int, need_full: bool, seed: int = 0) -> FramePacket:
    """Load frame ``idx`` and encode it as a FramePacket.

    Tracking pixels are per-iteration fresh uniform draws over the
    edge-trimmed image from a per-frame-seeded numpy generator (the same
    stream as the JAX package's build_packet).
    """
    rng = np.random.default_rng((seed + 1) * 1_000_003 + idx)
    H, W = dataset.frame_hw
    j = rng.integers(ie_h, H - ie_h, size=(iters, n_px)).astype(np.uint16)
    i = rng.integers(ie_w, W - ie_w, size=(iters, n_px)).astype(np.uint16)
    if not need_full:
        px_color, px_depth = dataset.sample_pixels(
            idx, i.reshape(-1).astype(np.int64),
            j.reshape(-1).astype(np.int64))
        return FramePacket(
            idx, dataset.poses[idx].astype(np.float32), i, j,
            _encode_color_u8(px_color).reshape(iters, n_px, 3),
            px_depth.astype(np.float32).reshape(iters, n_px),
            has_depthless=bool((px_depth <= 0).any()))
    color, depth, c2w = dataset.get_frame(idx)
    jc, ic = j.astype(np.int64), i.astype(np.int64)
    px_color = _encode_color_u8(color[jc, ic])
    px_depth = depth[jc, ic].astype(np.float32)
    q = 60000.0 / max(float(depth.max()) if depth.size else 0.0, 1e-3)
    # valid (>0) depths never quantize to 0 (0 encodes "no depth")
    depth_u16 = np.where(depth > 0, np.clip(np.rint(depth * q), 1, 65535),
                         0).astype(np.uint16)
    return FramePacket(
        idx, c2w, i, j, px_color, px_depth, _encode_color_u8(color),
        depth_u16, 1.0 / q, bool((depth <= 0).any()))


class PacketPrefetcher:
    """Background thread building FramePackets ahead of the SLAM loop
    (numpy rendering releases the interpreter lock)."""

    def __init__(self, dataset, indices, make_packet, depth: int = 4):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.indices = list(indices)
        self.dataset = dataset
        self.make_packet = make_packet
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        try:
            for idx in self.indices:
                self.q.put((idx, self.make_packet(self.dataset, idx)))
            self.q.put(None)
        except Exception as e:  # surface loader errors to the consumer
            self.q.put(e)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item


class Prefetcher(PacketPrefetcher):
    """Background thread loading whole frames ``(idx, (color, depth,
    c2w))`` ahead of the consumer (mesh culling reads from it)."""

    def __init__(self, dataset, indices, depth: int = 4):
        super().__init__(dataset, indices, lambda d, i: d.get_frame(i),
                         depth)
