"""RGB-D frame sources and the per-frame packet.

The port of ``myslam_tpu/utils/datasets.py``: the Replica, ScanNet and
TUM RGB-D readers of sequences on disk, and the procedural ``Synthetic``
room (AABB walls + spheres, exact depth and poses, rendered in numpy).
Frames are numpy arrays (color float32 HxWx3 in [0,1], depth float32
HxW in meters, c2w 4x4).  The readers decode with the port's own codec
(``utils/imageio.py``), never OpenCV, and keep the reference's behaviour:

  * the poses' y/z columns negated to the renderer's -z camera
    convention;
  * undistortion of color only;
  * a ``crop_size`` resize (bilinear with aligned corners for color,
    nearest for depth), then the ``crop_edge`` trim;
  * TUM's timestamp association (max_dt 0.08), frame-rate subsampling
    and first-pose rebasing.

``build_packet`` encodes a frame for the loop; on a CUDA device
``stage_packet`` starts its uploads from the prefetch thread.
"""

from __future__ import annotations

import glob
import os
import queue
import threading

import numpy as np
import torch

from myslam_torch.utils import imageio, trace


def get_dataset(cfg: dict, input_folder: str | None = None):
    name = cfg["dataset"]
    if name not in dataset_dict:
        raise ValueError(f"unknown dataset '{name}'")
    return dataset_dict[name](cfg, input_folder)


class BaseDataset:
    """A disk-backed RGB-D sequence in the reference's layout."""

    def __init__(self, cfg: dict, input_folder: str | None = None):
        self.name = cfg["dataset"]
        self.scale = cfg.get("scale", 1)
        cam = cfg["cam"]
        self.png_depth_scale = cam["png_depth_scale"]
        self.H, self.W = cam["H"], cam["W"]
        self.fx, self.fy = cam["fx"], cam["fy"]
        self.cx, self.cy = cam["cx"], cam["cy"]
        self.distortion = (
            np.array(cam["distortion"]) if "distortion" in cam else None)
        self.crop_size = cam.get("crop_size")
        self.crop_edge = cam.get("crop_edge", 0)
        self.input_folder = (input_folder if input_folder is not None
                             else cfg["data"]["input_folder"])
        self.color_paths: list[str] = []
        self.depth_paths: list[str] = []
        self.poses: list[np.ndarray] = []
        self.n_img = 0

    def __len__(self):
        return self.n_img

    @property
    def frame_hw(self) -> tuple:
        """The size of the frames get_frame returns (after the optional
        crop_size resize and the crop_edge trim)."""
        h, w = (self.crop_size if self.crop_size is not None
                else (self.H, self.W))
        e = self.crop_edge
        return h - 2 * e, w - 2 * e

    def get_frame(self, index: int):
        color = imageio.imread_rgb(self.color_paths[index])
        depth = imageio.imread(self.depth_paths[index])
        if self.distortion is not None:
            K = np.eye(3)
            K[0, 0], K[1, 1] = self.fx, self.fy
            K[0, 2], K[1, 2] = self.cx, self.cy
            # undistortion applies to color only (reference datasets.py:86)
            color = imageio.undistort(color, K, self.distortion)
        color = color.astype(np.float32) / 255.0
        depth = depth.astype(np.float32) / self.png_depth_scale * self.scale
        H, W = depth.shape
        if color.shape[:2] != (H, W):
            color = imageio.resize_linear(color, W, H)
        if self.crop_size is not None:
            ch, cw = self.crop_size
            color = imageio.resize_align_corners(color, ch, cw)
            depth = imageio.resize_nearest(depth, cw, ch)
        e = self.crop_edge
        if e > 0:
            color = color[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
        pose = self.poses[index].copy()
        pose[:3, 3] *= self.scale
        return color, depth, pose.astype(np.float32)


def _flip_yz(c2w: np.ndarray) -> np.ndarray:
    """Negate the y and z columns: the dataset's camera convention to
    the renderer's -z forward one."""
    c2w = c2w.copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return c2w.astype(np.float32)


class Replica(BaseDataset):
    """``results/frame*.jpg``, ``results/depth*.png``, ``traj.txt`` (one
    flattened c2w per line)."""

    def __init__(self, cfg, input_folder=None):
        super().__init__(cfg, input_folder)
        self.color_paths = sorted(
            glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        with open(f"{self.input_folder}/traj.txt") as f:
            lines = f.readlines()
        self.poses = [_flip_yz(np.array(list(map(float, lines[i].split())))
                               .reshape(4, 4)) for i in range(self.n_img)]


class ScanNet(BaseDataset):
    """``color/<i>.jpg``, ``depth/<i>.png``, ``pose/<i>.txt``, in
    numeric order.  Poses of frames the sensor lost hold nan or inf and
    pass through (``tools/eval_ate.py`` masks them); frame 0's must be
    valid, since the run starts from it."""

    def __init__(self, cfg, input_folder=None):
        super().__init__(cfg, input_folder)

        def by_num(p):
            return int(os.path.basename(p).split(".")[0])

        def listing(sub, ext):
            return sorted(glob.glob(os.path.join(self.input_folder, sub,
                                                 f"*.{ext}")), key=by_num)

        self.color_paths = listing("color", "jpg")
        self.depth_paths = listing("depth", "png")
        self.poses = [_flip_yz(np.loadtxt(p).reshape(4, 4))
                      for p in listing("pose", "txt")]
        self.n_img = len(self.color_paths)
        if self.n_img and not np.isfinite(self.poses[0]).all():
            raise ValueError(f"{self.input_folder}: frame 0's pose is not "
                             "finite")


class TUMRGBD(BaseDataset):
    """``rgb.txt``, ``depth.txt`` and ``groundtruth.txt`` (or
    ``pose.txt``) of timestamped files, associated within 0.08 s,
    subsampled to ``frame_rate``; the first pose is rebased to the
    identity before the column flip."""

    def __init__(self, cfg, input_folder=None, frame_rate: int = 32):
        super().__init__(cfg, input_folder)
        self.color_paths, self.depth_paths, self.poses = self._load_tum(
            self.input_folder, frame_rate)
        self.n_img = len(self.color_paths)

    @staticmethod
    def _parse_list(filepath, skiprows=0):
        return np.atleast_2d(np.loadtxt(
            filepath, delimiter=" ", dtype=np.str_, skiprows=skiprows))

    @staticmethod
    def associate_frames(t_img, t_depth, t_pose, max_dt=0.08):
        """(image, depth, pose) index triples of each image whose nearest
        depth and pose timestamps lie within ``max_dt``."""
        associations = []
        for i, t in enumerate(t_img):
            j = int(np.argmin(np.abs(t_depth - t)))
            k = int(np.argmin(np.abs(t_pose - t)))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                associations.append((i, j, k))
        return associations

    def _load_tum(self, datapath, frame_rate):
        pose_list = os.path.join(datapath, "groundtruth.txt")
        if not os.path.isfile(pose_list):
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self._parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)

        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        associations = self.associate_frames(t_img, t_depth, t_pose)

        # subsample to ~frame_rate using image timestamps
        indices = [0]
        for i in range(1, len(associations)):
            t0 = t_img[associations[indices[-1]][0]]
            t1 = t_img[associations[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        images, depths, poses = [], [], []
        inv_pose = None
        for ix in indices:
            i, j, k = associations[ix]
            images.append(os.path.join(datapath, str(image_data[i, 1])))
            depths.append(os.path.join(datapath, str(depth_data[j, 1])))
            c2w = self._pose_matrix_from_quaternion(pose_vecs[k])
            if inv_pose is None:  # rebase so the first pose is identity
                inv_pose = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_pose @ c2w
            poses.append(_flip_yz(c2w))
        return images, depths, poses

    @staticmethod
    def _pose_matrix_from_quaternion(pvec):
        from scipy.spatial.transform import Rotation

        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()
        pose[:3, 3] = pvec[:3]
        return pose


class Synthetic:
    """Procedural room (AABB walls + two spheres) rendered analytically.

    cfg['data'] may set n_frames, room, spheres and ang_step; the
    intrinsics come from cfg['cam'].  Colors are smooth position-based
    patterns.
    """

    def __init__(self, cfg: dict, input_folder: str | None = None):
        # Procedural: there is no folder to read, so input_folder is
        # ignored.
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

    Once staged (``stage_packet``) those fields are CUDA tensors whose
    copies may still run: ``wait_staged`` orders the caller's stream
    after them.  ``color_u8_host`` / ``depth_u16_host`` keep the numpy
    imagery for consumers on the host (the host-staged keyframe store).
    """

    __slots__ = ("idx", "gt_c2w", "px_i", "px_j", "px_color", "px_depth",
                 "color_u8", "depth_u16", "depth_inv_q", "has_depthless",
                 "color_u8_host", "depth_u16_host", "ready")

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
        self.color_u8_host = None
        self.depth_u16_host = None
        self.ready = None  # the staged copies' event

    def imagery_host(self):
        """(color_u8, depth_u16) as host arrays, with no device read when
        the packet was staged."""
        if self.color_u8_host is not None:
            return self.color_u8_host, self.depth_u16_host
        return self.color_u8, self.depth_u16


# The packet's arrays that stage_packet uploads.
STAGED_FIELDS = ("px_i", "px_j", "px_color", "px_depth", "color_u8",
                 "depth_u16")


def _encode_color_u8(color: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(color * 255.0), 0, 255).astype(np.uint8)


def build_packet(dataset, idx: int, *, iters: int, n_px: int, ie_h: int,
                 ie_w: int, need_full: bool, seed: int = 0) -> FramePacket:
    """Load frame ``idx`` and encode it as a FramePacket.

    Tracking pixels are per-iteration fresh uniform draws over the
    edge-trimmed image from a per-frame-seeded numpy generator (the same
    stream as the JAX package's build_packet).  A procedural dataset
    renders only those pixels for a frame that is not mapped; a disk
    dataset reads the whole frame.
    """
    rng = np.random.default_rng((seed + 1) * 1_000_003 + idx)
    H, W = dataset.frame_hw
    j = rng.integers(ie_h, H - ie_h, size=(iters, n_px)).astype(np.uint16)
    i = rng.integers(ie_w, W - ie_w, size=(iters, n_px)).astype(np.uint16)
    if not need_full and hasattr(dataset, "sample_pixels"):
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
    # has_depthless reflects the whole frame, not only its pixels drawn
    pkt = FramePacket(idx, c2w, i, j, px_color, px_depth,
                      has_depthless=bool((depth <= 0).any()))
    if need_full:
        q = 60000.0 / max(float(depth.max()) if depth.size else 0.0, 1e-3)
        # valid (>0) depths never quantize to 0 (0 encodes "no depth")
        pkt.depth_u16 = np.where(
            depth > 0, np.clip(np.rint(depth * q), 1, 65535), 0).astype(
                np.uint16)
        pkt.color_u8 = _encode_color_u8(color)
        pkt.depth_inv_q = 1.0 / q
    return pkt


class PinnedRing:
    """Pinned host buffers that ``stage_packet`` reuses, and its copy
    stream.

    ``slots`` sets of buffers (one per packet field, grown on demand) are
    taken in turn.  A slot is refilled only after the event recorded
    behind its previous copies has completed, so a copy never reads a
    buffer that the next packet is writing; pinning memory per packet
    would cost milliseconds per MB.
    """

    def __init__(self, device, slots: int = 6):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._slots = [{"event": None, "bufs": {}} for _ in range(slots)]
        self._next = 0
        self.allocations = 0  # pinned buffers allocated so far

    def take(self) -> dict:
        """The next slot, once its previous copies have completed."""
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot["event"] is not None:
            slot["event"].synchronize()
        return slot

    def pinned(self, slot: dict, name: str, arr: np.ndarray) -> torch.Tensor:
        """``arr`` copied into the slot's pinned buffer for ``name``, as a
        tensor of its dtype and shape."""
        buf = slot["bufs"].get(name)
        if buf is None or buf.numel() < arr.nbytes:
            buf = torch.empty(max(arr.nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            slot["bufs"][name] = buf
            self.allocations += 1
        buf.numpy()[:arr.nbytes].view(arr.dtype).reshape(arr.shape)[...] = arr
        # A view of the pinned buffer itself (not of a numpy alias), so
        # that the copy knows its source is pinned.
        dtype = torch.from_numpy(arr[:0].reshape(-1)).dtype
        return buf[:arr.nbytes].view(dtype).view(arr.shape)


def stage_packet(pkt: FramePacket, ring: PinnedRing) -> FramePacket:
    """Start the packet's host-to-device copies (in place), from the
    prefetch thread: each array through a pinned buffer of ``ring``, as a
    non-blocking copy on the ring's stream, then an event behind them
    (``pkt.ready``).  The numpy imagery stays on the packet for host
    consumers."""
    slot = ring.take()
    if pkt.color_u8 is not None:
        pkt.color_u8_host = pkt.color_u8
        pkt.depth_u16_host = pkt.depth_u16
    with torch.cuda.stream(ring.stream):
        for name in STAGED_FIELDS:
            arr = getattr(pkt, name)
            if arr is None:
                continue
            host = ring.pinned(slot, name, np.ascontiguousarray(arr))
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=ring.device)
            dev.copy_(host, non_blocking=True)
            setattr(pkt, name, dev)
        event = torch.cuda.Event()
        event.record(ring.stream)
    slot["event"] = pkt.ready = event
    return pkt


def wait_staged(pkt: FramePacket) -> FramePacket:
    """Order the current stream after the packet's staged copies, and
    tell the caching allocator that this stream uses its tensors (so
    their memory is not handed out again before this stream is done
    with them).  A packet that was not staged is returned as is."""
    if pkt.ready is None:
        return pkt
    stream = torch.cuda.current_stream(pkt.px_i.device)
    stream.wait_event(pkt.ready)
    for name in STAGED_FIELDS:
        t = getattr(pkt, name)
        if isinstance(t, torch.Tensor):
            t.record_stream(stream)
    pkt.ready = None
    return pkt


class PacketPrefetcher:
    """Background thread building FramePackets ahead of the SLAM loop
    (decoding and numpy rendering release the interpreter lock).  With
    ``stage`` (a CUDA device) it also starts each packet's uploads
    through a ring of pinned buffers (``stage_packet``); the consumer
    calls ``wait_staged`` before it uses a packet.  The consumer's wait
    for each item is a ``prefetch_wait`` span (``utils/trace.py``)."""

    def __init__(self, dataset, indices, make_packet, depth: int = 4,
                 stage=None):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.indices = list(indices)
        self.dataset = dataset
        self.make_packet = make_packet
        # Queued packets, the one being built and the one being consumed
        # each hold a slot, so the ring rarely waits.
        self.ring = PinnedRing(stage, depth + 2) if stage else None
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        try:
            for idx in self.indices:
                pkt = self.make_packet(self.dataset, idx)
                if self.ring is not None:
                    pkt = stage_packet(pkt, self.ring)
                self.q.put((idx, pkt))
            self.q.put(None)
        except Exception as e:  # surface loader errors to the consumer
            self.q.put(e)

    def __iter__(self):
        while True:
            with trace.span("prefetch_wait"):
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


dataset_dict = {
    "replica": Replica,
    "scannet": ScanNet,
    "tumrgbd": TUMRGBD,
    "synthetic": Synthetic,
}
