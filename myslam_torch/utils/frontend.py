"""Interactive replay frontend: a child process fed through a queue.

The counterpart of ``myslam_tpu.utils.frontend``.  The caller pushes
per-frame estimated and ground-truth poses and mesh-swap events; the
child draws growing trajectories (red estimated, green ground truth)
and the newest mesh.  Backends:

  * ``open3d``      -- an interactive window (lazy import of open3d,
                       inside the backend; used by ``auto`` when open3d
                       is installed and a display exists);
  * ``matplotlib``  -- an interactive 2-D top view (lazy import of
                       matplotlib, inside the backend);
  * ``headless``    -- records top views as ``{output}/vis/live_*.jpg``
                       (numpy raster, the port's JPEG codec), every 10th
                       received pose and a final one; always available;
  * ``mock``        -- an in-process recorder for tests.

The open3d and matplotlib backends are copies of the JAX package's; no
machine the port was checked on has open3d, and the card's has no
matplotlib, so both are untested.  ``visualizer_torch.py --interactive``
drives this; ``SLAMSystem.on_map_done`` can too.  The child process is
started with the ``spawn`` method.
"""

from __future__ import annotations

import importlib.util
import multiprocessing as mp
import os
import queue as _queue

import numpy as np

# Frame size of the headless recorder's top views, and its stride in
# received poses.
LIVE_HW = 480
LIVE_EVERY = 10


def pick_backend(requested: str = "auto") -> str:
    """The display backend: ``auto`` takes open3d when it is installed
    and a display exists, then matplotlib when a display exists and
    MPLBACKEND names no file backend, else the headless recorder."""
    if requested != "auto":
        return requested
    have_display = bool(os.environ.get("DISPLAY")
                        or os.environ.get("WAYLAND_DISPLAY"))
    if not have_display:
        return "headless"
    if importlib.util.find_spec("open3d") is not None:
        return "open3d"
    if (importlib.util.find_spec("matplotlib") is not None
            and os.environ.get("MPLBACKEND", "").lower()
            not in ("agg", "pdf", "svg")):
        return "matplotlib"
    return "headless"


class SLAMFrontend:
    """The caller's side (``start``, ``update_pose``, ``update_mesh``,
    ``join``), as in the JAX package and the reference."""

    def __init__(self, output: str, save_rendering: bool = False,
                 backend: str = "auto"):
        self._ctx = mp.get_context("spawn")
        self.queue = self._ctx.Queue()
        self.output = output
        self.backend = pick_backend(backend)
        self.save_rendering = save_rendering
        self._mock_events: list = []
        self._proc = None

    def start(self) -> "SLAMFrontend":
        if self.backend == "mock":
            return self
        self._proc = self._ctx.Process(
            target=_frontend_loop,
            args=(self.queue, self.backend, self.output,
                  self.save_rendering))
        self._proc.daemon = True
        self._proc.start()
        return self

    def update_pose(self, index: int, pose, gt_pose=None) -> None:
        self._push(("pose", int(index), np.asarray(pose),
                    None if gt_pose is None else np.asarray(gt_pose)))

    def update_mesh(self, path: str) -> None:
        self._push(("mesh", str(path)))

    def join(self) -> None:
        self._push(("close",))
        if self._proc is not None:
            self._proc.join(timeout=30)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(timeout=5)

    def _push(self, msg) -> None:
        if self.backend == "mock":
            self._mock_events.append(msg)
        else:
            self.queue.put(msg)


def _frontend_loop(q, backend: str, output: str,
                   save_rendering: bool) -> None:
    """The child process: drain the queue into the backend."""
    if backend == "open3d":
        _open3d_loop(q, output, save_rendering)
    elif backend == "matplotlib":
        _matplotlib_loop(q, output)
    else:
        _headless_loop(q, output)


def _drain(q, block: bool):
    try:
        return q.get(block=block, timeout=0.05 if block else None)
    except _queue.Empty:
        return None


def _open3d_loop(q, output: str, save_rendering: bool) -> None:
    """Open3D window with an animation callback: growing red and green
    trajectory line sets, meshes swapped in place (untested: open3d is
    not installed where the port is checked)."""
    import open3d as o3d

    vis = o3d.visualization.Visualizer()
    vis.create_window(window_name="myslam_torch", width=1280, height=720)
    state = {"est": [], "gt": [], "mesh_geom": None, "traj": None,
             "gt_traj": None}

    def make_lines(points, color):
        if len(points) < 2:
            return None
        ls = o3d.geometry.LineSet()
        ls.points = o3d.utility.Vector3dVector(np.asarray(points))
        ls.lines = o3d.utility.Vector2iVector(
            [[i, i + 1] for i in range(len(points) - 1)])
        ls.colors = o3d.utility.Vector3dVector([color] * (len(points) - 1))
        return ls

    def tick(vis):
        msg = _drain(q, block=False)
        if msg is None:
            return False
        if msg[0] == "close":
            vis.close()
            return False
        if msg[0] == "mesh":
            mesh = o3d.io.read_triangle_mesh(msg[1])
            mesh.compute_vertex_normals()
            if state["mesh_geom"] is not None:
                vis.remove_geometry(state["mesh_geom"], False)
            vis.add_geometry(mesh, reset_bounding_box=state["mesh_geom"]
                             is None)
            state["mesh_geom"] = mesh
        elif msg[0] == "pose":
            _, i, est, gt = msg
            state["est"].append(est[:3, 3])
            if gt is not None:
                state["gt"].append(gt[:3, 3])
            for key, pts, color in (("traj", state["est"], [1.0, 0.0, 0.0]),
                                    ("gt_traj", state["gt"],
                                     [0.0, 1.0, 0.0])):
                ls = make_lines(pts, color)
                if ls is None:
                    continue
                if state[key] is not None:
                    vis.remove_geometry(state[key], False)
                vis.add_geometry(ls, reset_bounding_box=False)
                state[key] = ls
            if save_rendering:
                os.makedirs(os.path.join(output, "vis"), exist_ok=True)
                vis.capture_screen_image(
                    os.path.join(output, "vis", f"{i:05d}.jpg"))
        return True

    vis.register_animation_callback(tick)
    vis.run()
    vis.destroy_window()


def _matplotlib_loop(q, output: str) -> None:
    """Interactive matplotlib top view of the trajectories (untested:
    the card's machine has no matplotlib)."""
    import matplotlib.pyplot as plt

    plt.ion()
    fig, ax = plt.subplots(figsize=(7, 7))
    est_x, est_y, gt_x, gt_y = [], [], [], []
    (l_est,) = ax.plot([], [], "-", color="red", label="estimated")
    (l_gt,) = ax.plot([], [], "-", color="green", label="ground truth")
    ax.legend(loc="upper right")
    ax.set_aspect("equal")
    while True:
        msg = _drain(q, block=True)
        if msg is None:
            plt.pause(0.01)
            continue
        if msg[0] == "close":
            break
        if msg[0] == "pose":
            _, i, est, gt = msg
            est_x.append(est[0, 3])
            est_y.append(est[1, 3])
            l_est.set_data(est_x, est_y)
            if gt is not None:
                gt_x.append(gt[0, 3])
                gt_y.append(gt[1, 3])
                l_gt.set_data(gt_x, gt_y)
            ax.relim()
            ax.autoscale_view()
            ax.set_title(f"frame {i}")
            fig.canvas.draw_idle()
            plt.pause(0.001)
    plt.ioff()
    plt.close(fig)


def render_top_view(est: list, gt: list, size: int = LIVE_HW) -> np.ndarray:
    """A (size, size, 3) uint8 top view (x right, y up) of the estimated
    (red) and ground-truth (green) camera positions, fitted to the frame."""
    from myslam_torch.utils.draw import GREEN, RED, draw_dot, \
        draw_polyline, fit_view

    img = np.full((size, size, 3), 255, np.uint8)
    pts = np.asarray(list(est) + list(gt), np.float64)[:, :2]
    project = fit_view(pts, size, size)
    if len(gt):
        draw_polyline(img, *project(np.asarray(gt)[:, :2]), GREEN)
    if len(est):
        u, v = project(np.asarray(est)[:, :2])
        draw_polyline(img, u, v, RED)
        draw_dot(img, u[-1], v[-1], RED)
    return img


def _headless_loop(q, output: str) -> None:
    """No display: the events as numbered top views under
    ``{output}/vis``: every LIVE_EVERY-th received pose (counted here,
    since the caller's indices arrive strided) and, at close, the last
    one unless it was just drawn."""
    from myslam_torch.utils.imageio import write_jpeg

    vis_dir = os.path.join(output, "vis")
    os.makedirs(vis_dir, exist_ok=True)
    est, gt = [], []
    n_rx = 0
    last_i = 0

    def save(i):
        write_jpeg(os.path.join(vis_dir, f"live_{i:05d}.jpg"),
                   render_top_view(est, gt))

    while True:
        msg = _drain(q, block=True)
        if msg is None:
            continue
        if msg[0] == "close":
            if est and n_rx % LIVE_EVERY != 1:
                save(last_i)
            break
        if msg[0] == "pose":
            _, i, e, g = msg
            est.append(e[:3, 3])
            if g is not None:
                gt.append(g[:3, 3])
            n_rx += 1
            last_i = int(i)
            if n_rx % LIVE_EVERY == 1:
                save(last_i)
