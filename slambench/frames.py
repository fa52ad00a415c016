"""The benchmark's frame source: the analytic room rendered on the card.

A frozen PyTorch copy of the procedural room (axis-aligned walls and two
spheres, smooth position-based colours, exact perpendicular depth) and of
its orbit (``ang_step`` radians a frame), rendered frame by frame on the
device on a stream of its own, so that a render never waits for the
loop's queued work.  It hands the loop host arrays through the interface
the loop reads of a dataset: ``frame_hw``, ``poses``, ``get_frame``,
``sample_pixels`` and ``__len__``.

``--seed`` sets the orbit's starting phase; the traffic's ``holes`` add
sensor-like depth dropout (blobs drawn per frame from the seed, and a band
along depth edges).  ``seconds`` keeps the host time spent rendering, so
that a run can show that the source never sets the pace.  ``close()``
makes every later call raise ``SourceClosed``: the loop's prefetch thread
then ends.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time

import numpy as np
import torch


class SourceClosed(RuntimeError):
    """The run is over; the prefetch thread asked for another frame."""


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """c2w (4, 4) float64 with the renderer's -z-forward convention."""
    up = np.array([0.0, 0.0, 1.0])
    f = target - eye
    f = f / np.linalg.norm(f)
    z = -f
    x = np.cross(f, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def orbit_pose(room: np.ndarray, ang: float) -> np.ndarray:
    """The camera pose at orbit angle ``ang`` about the room's centre."""
    center = room.mean(axis=1)
    eye = center + np.array(
        [0.9 * np.cos(ang), 0.9 * np.sin(ang), 0.25 * np.sin(2 * ang)])
    target = center + np.array(
        [1.6 * np.cos(ang + 0.9), 1.6 * np.sin(ang + 0.9), 0.1])
    return look_at(eye, target).astype(np.float32)


def orbit_phase(seed: int) -> float:
    """The orbit's starting angle for ``seed``: uniform in [0, 2 pi)."""
    return float(np.random.default_rng(int(seed)).uniform(0.0, 2 * np.pi))


def raycast(o: torch.Tensor, d: torch.Tensor, room: torch.Tensor,
            spheres: torch.Tensor):
    """Colour (..., 3) and hit distance (...,) of rays from ``o`` (3,)
    along ``d`` (..., 3), float32: the first hit of the spheres or the
    room's inside, t along the unnormalised direction (the perpendicular
    depth for camera directions with z = -1)."""
    tt = (room[None] - o[None, :, None]) / d.reshape(-1, 3)[..., None]
    t_hit = tt.amax(dim=-1).amin(dim=-1)
    obj = torch.zeros_like(t_hit)
    dd = d.reshape(-1, 3)
    a = (dd * dd).sum(-1)
    for si in range(spheres.shape[0]):
        oc = o - spheres[si, :3]
        b = 2.0 * (dd @ oc)
        c0 = oc @ oc - spheres[si, 3] * spheres[si, 3]
        disc = b * b - 4 * a * c0
        t_s = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
        hit = (disc > 0) & (t_s > 1e-4) & (t_s < t_hit)
        t_hit = torch.where(hit, t_s, t_hit)
        obj = torch.where(hit, torch.full_like(obj, si + 1.0), obj)
    pts = o[None] + t_hit[:, None] * dd
    phase = (torch.tensor([0.0, 2.1, 4.2], device=d.device)[None]
             + obj[:, None] * 1.3)
    freq = 2.0 + 1.5 * obj[:, None]
    color = (0.5 + 0.35 * torch.sin(freq * pts + phase)
             + 0.15 * torch.cos(3.1 * pts[:, [1, 2, 0]]))
    color = torch.clamp(color, 0.0, 1.0)
    return color.reshape(d.shape), t_hit.reshape(d.shape[:-1])


class FrameSource:
    """The orbit's frames for one run (see the module's docstring).

    ``cfg`` gives the camera (``cam``) and the room (``data.room``,
    ``data.spheres``); ``traffic`` the orbit and the holes; ``n`` the
    sequence length."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, n: int,
                 device):
        cam = cfg["cam"]
        self.H, self.W = int(cam["H"]), int(cam["W"])
        self.fx, self.fy = float(cam["fx"]), float(cam["fy"])
        self.cx, self.cy = float(cam["cx"]), float(cam["cy"])
        data = cfg["data"]
        self.room = np.array(data["room"], np.float64)
        self.device = torch.device(device)
        self.room_t = torch.tensor(self.room, dtype=torch.float32,
                                   device=self.device)
        self.spheres_t = torch.tensor(data["spheres"], dtype=torch.float32,
                                      device=self.device)
        orbit = traffic["orbit"]
        phase = orbit_phase(seed) if orbit.get("phase_from_seed") else 0.0
        self.seed = int(seed)
        self.ang0 = -0.45 * np.pi + phase
        self.ang_step = float(orbit["ang_step"])
        self.n = int(n)
        self.poses = [orbit_pose(self.room, self.ang0 + i * self.ang_step)
                      for i in range(self.n)]
        self.holes = traffic.get("holes")
        j, i = torch.meshgrid(
            torch.arange(self.H, dtype=torch.float32, device=self.device),
            torch.arange(self.W, dtype=torch.float32, device=self.device),
            indexing="ij")
        self.dirs = torch.stack([(i - self.cx) / self.fx,
                                 -(j - self.cy) / self.fy,
                                 -torch.ones_like(i)], dim=-1)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.lock = threading.Lock()
        self.closed = False
        # Host CPU seconds of the calling thread in get_frame and
        # sample_pixels (waits for the device or the interpreter lock
        # excluded), their wall seconds, and the calls.
        self.cpu_seconds = 0.0
        self.seconds = 0.0
        self.calls = 0
        self.hole_share: list[float] = []

    def __len__(self) -> int:
        return self.n

    @property
    def frame_hw(self) -> tuple:
        return self.H, self.W

    def close(self) -> None:
        self.closed = True

    # -- rendering -----------------------------------------------------------

    def _stream_ctx(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def render(self, index: int):
        """Colour (H, W, 3) and depth (H, W) of frame ``index`` on the
        device, float32, with the traffic's holes (depth 0)."""
        c2w = torch.tensor(self.poses[index], device=self.device)
        d = self.dirs @ c2w[:3, :3].T
        color, depth = raycast(c2w[:3, 3], d, self.room_t, self.spheres_t)
        if self.holes:
            depth = torch.where(self.hole_mask(index, depth),
                                torch.zeros_like(depth), depth)
        return color, depth

    def hole_mask(self, index: int, depth: torch.Tensor) -> torch.Tensor:
        """Pixels whose depth the sensor drops: ``blobs`` ellipses per
        frame (centres, radii and aspect drawn from (seed, index)) that
        cover about ``blob_share`` of the image, and both sides of every
        depth jump above ``edge_jump_m`` between 4-neighbours."""
        h = self.holes
        rng = np.random.default_rng([self.seed, int(index)])
        nb = int(h["blobs"])
        area = float(h["blob_share"]) * self.H * self.W / nb
        j = torch.arange(self.H, device=depth.device,
                         dtype=torch.float32)[:, None]
        i = torch.arange(self.W, device=depth.device,
                         dtype=torch.float32)[None, :]
        mask = torch.zeros_like(depth, dtype=torch.bool)
        for cy, cx, aspect in zip(rng.uniform(0, self.H, nb),
                                  rng.uniform(0, self.W, nb),
                                  rng.uniform(0.5, 2.0, nb)):
            ry = math.sqrt(area / math.pi / aspect)
            rx = ry * aspect
            mask |= ((j - cy) / ry) ** 2 + ((i - cx) / rx) ** 2 <= 1.0
        jump = float(h["edge_jump_m"])
        dy = (depth[1:] - depth[:-1]).abs() > jump
        dx = (depth[:, 1:] - depth[:, :-1]).abs() > jump
        edge = torch.zeros_like(mask)
        edge[1:] |= dy
        edge[:-1] |= dy
        edge[:, 1:] |= dx
        edge[:, :-1] |= dx
        return mask | edge

    def _timed_host(self, fn):
        if self.closed:
            raise SourceClosed("the benchmark's window is over")
        t0, c0 = time.perf_counter(), time.thread_time()
        with self.lock, self._stream_ctx():
            out = fn()
        with self.lock:
            self.seconds += time.perf_counter() - t0
            self.cpu_seconds += time.thread_time() - c0
            self.calls += 1
        return out

    def get_frame(self, index: int):
        """(color (H, W, 3), depth (H, W), c2w (4, 4)), float32 numpy."""
        def run():
            color, depth = self.render(index)
            if self.holes:
                self.hole_share.append(float((depth <= 0).float().mean()))
            return (color.cpu().numpy(), depth.cpu().numpy(),
                    self.poses[index].copy())
        return self._timed_host(run)

    def frame_host(self, index: int):
        """``get_frame`` for the reference, after the window: neither
        refused once closed nor counted in ``seconds``."""
        with self.lock, self._stream_ctx():
            color, depth = self.render(index)
            return (color.cpu().numpy(), depth.cpu().numpy(),
                    self.poses[index].copy())

    def sample_pixels(self, index: int, i: np.ndarray, j: np.ndarray):
        """Colour (N, 3) and depth (N,) at pixel columns ``i`` and rows
        ``j``: only those rays are cast, unless there are holes, whose
        edges need the neighbours: then the whole frame is rendered."""
        def run():
            ii = torch.as_tensor(np.asarray(i, np.int64), device=self.device)
            jj = torch.as_tensor(np.asarray(j, np.int64), device=self.device)
            if self.holes:
                color, depth = self.render(index)
                return (color[jj, ii].cpu().numpy(),
                        depth[jj, ii].cpu().numpy())
            c2w = torch.tensor(self.poses[index], device=self.device)
            d = self.dirs[jj, ii] @ c2w[:3, :3].T
            color, depth = raycast(c2w[:3, 3], d, self.room_t,
                                   self.spheres_t)
            return color.cpu().numpy(), depth.cpu().numpy()
        return self._timed_host(run)
