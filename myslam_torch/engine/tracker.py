"""Per-frame camera tracking: Adam on a 7-dof pose against a frozen map.

Reference semantics, as in ``myslam_tpu.engine.tracker``:
  * a fresh Adam per frame, betas (0.5, 0.999), separate groups (and
    learning rates) for the quaternion R and the translation T;
  * the loss of each iteration is taken at the pre-update pose, and the
    pose with the lowest such loss wins;
  * rays leaving the bound before their depth, depth-less rays, and
    rays whose depth error exceeds 10x the median are masked out;
  * fresh pixels every iteration (drawn on the host, ``build_packet``).

One iteration body runs that math (``StaticFrame.body``): the loss, the
pose gradient, ``torch.optim.Adam``'s step and the best-pose
bookkeeping, over fixed buffers (the frame's pixels and depth-guided
jitter as (iters, n[, S]) rows picked by a device index, the pose
leaves, Adam's state, the results).  Per frame the host copies in the
pixels and the start pose, draws the frame's jitter from the caller's
source in iteration order, zeroes Adam's state in place (a fresh Adam),
runs the body ``iters`` times and returns copies of the results.  How
the body runs is chosen by what the call can observe (``replayable``),
never by a setting:

  * replayed, on a CUDA device when not ``sharded`` and while the
    sample's entry points ``cuda_sample.plane_sample_fwd`` and
    ``plane_sample_bwd`` are the module's own: the body is captured once
    as a CUDA graph and replayed ``iters`` times a frame; the capturing
    frame runs its first ``WARMUP_ITERS`` iterations eagerly to set up
    what a capture cannot.  The graph is captured again when the pixel
    count, ``iters``, the quads' dtype or shape, or the storage of a
    decoder parameter changes; mapping updates the decoders in place,
    so a run captures once;
  * eager otherwise: Python launches every operation of every
    iteration.  That covers CPU tensors, the ``sharded`` trackers (their
    iterations run collectives), and a replaced sample entry point: a
    graph replays only the kernels its capture saw, so a wrapper of K1's
    and K2's entry points (a recorder of their calls, say) would see the
    capture's calls and none of the replays.

``GRAPH_COUNTS`` counts captures, replayed iterations and iterations run
eagerly (a capturing frame's first ones among them).  A replay adds the
K1/K2 launches its capture recorded to ``cuda_sample.LAUNCHES``, and a
capture takes its own back (a captured kernel does not run then), so the
counter still counts every run of the kernels on the device.

Spans (``utils/trace.py``): ``track.pack`` per group; per iteration
``track.iter``, holding ``track.loss``, ``track.grad`` and
``track.step`` when the body runs eagerly and one replay's launch when
it is replayed; ``track.capture`` around a capture and the eager
iterations before it.

``sharded``: the pixel batch of each iteration splits over the ranks of
the process group (``parallel/distributed.py``), as the JAX package's
``ray_sharding`` splits it over a mesh: each rank renders its contiguous
share (padded rays masked out) with its rows of the batch's draws
(``RowShardDraws``); the outlier threshold is the median of every rank's
depth errors (one all-gather), the masked means are global (one
all-reduce of their sums and counts), and the 7-float pose gradient is
summed (one all-reduce).  The result is the single-device optimization
up to float reduction order, the same on every rank.
"""

from __future__ import annotations

import weakref

import torch

from myslam_torch.core.geometry import ray_aabb_exit_t, rays_from_uv
from myslam_torch.core.losses import color_loss, depth_loss, \
    global_weighted_loss, masked_median, sdf_losses, slam_terms
from myslam_torch.core.quaternion import cam_pose_to_matrix, \
    matrix_to_cam_pose
from myslam_torch.core.sampling import RowShardDraws, rank_rows
from myslam_torch.engine.camera import Camera
from myslam_torch.models.planes import MapState
from myslam_torch.ops import cuda_sample
from myslam_torch.ops.plane_sample import pack_quad
from myslam_torch.parallel import distributed
from myslam_torch.render.renderer import SceneGeometry, render_rays
from myslam_torch.utils import trace
from myslam_torch.utils.graphs import CountedGraph

ADAM_BETAS = (0.5, 0.999)
# A capturing frame's first iterations, run eagerly on a side stream
# before the capture (``StaticFrame.capture``).
WARMUP_ITERS = 2

# How often tracking took each path (see the module's docstring).
GRAPH_COUNTS = {"captures": 0, "replays": 0, "eager_iters": 0}

# The sample's entry points as the module defines them.
_SAMPLE_FWD = cuda_sample.plane_sample_fwd
_SAMPLE_BWD = cuda_sample.plane_sample_bwd


def replayable(pose_init: torch.Tensor, sharded: bool) -> bool:
    """Whether a frame's iterations replay one captured graph: on a CUDA
    device, without collectives (not ``sharded``), and with the sample's
    entry points not replaced."""
    return (pose_init.device.type == "cuda" and not sharded
            and cuda_sample.plane_sample_fwd is _SAMPLE_FWD
            and cuda_sample.plane_sample_bwd is _SAMPLE_BWD)


class _SlotDraws:
    """The iteration body's draw source: one ``uniform`` of the jitter
    slots' shape, served from row ``it`` (a device index) of the frame's
    jitter.  Any other draw raises."""

    __slots__ = ("jitter", "it", "used")

    def __init__(self, jitter, it):
        self.jitter, self.it, self.used = jitter, it, False

    def uniform(self, shape) -> torch.Tensor:
        want = None if self.jitter is None else tuple(self.jitter.shape[1:])
        if self.used or tuple(shape) != want:
            raise ValueError(f"the tracking iteration drew {tuple(shape)}; "
                             f"its slots hold one draw of {want}")
        self.used = True
        return self.jitter.index_select(0, self.it)[0]

    def randint(self, shape, low: int, high: int) -> torch.Tensor:
        raise ValueError("the tracking iteration draws no integers")


class StaticFrame:
    """One frame's optimization over fixed buffers: what the iteration
    body reads and writes, and so what a captured graph of it replays.

    ``body`` runs iteration ``it`` (a device int64 index) from the
    buffers alone: the pixels and the jitter are row ``it`` of the
    frame's (``index_select``), the pose is the leaves ``R`` and ``T``
    under ``opt`` (``torch.optim.Adam``, its state on the device and
    capturable on a CUDA device).  It writes the iteration's loss and
    pre-update pose, the best loss and pose, the Adam step and ``it + 1``
    in place.  ``load`` puts a frame in."""

    def __init__(self, loss_fn, iters: int, lr_R: float, lr_T: float,
                 sharded: bool, px, quads, pose_init, jitter_shape):
        dev = pose_init.device
        self.loss_fn = loss_fn
        self.iters = iters
        self.sharded = sharded
        self.px = [torch.empty_like(x) for x in px]
        self.quads = tuple(torch.empty_like(q) for q in quads)
        self.quad_src: tuple = ()
        self.jitter = (None if jitter_shape is None else torch.empty(
            (iters,) + tuple(jitter_shape), device=dev))
        self.R = torch.zeros(4, device=dev, requires_grad=True)
        self.T = torch.zeros(3, device=dev, requires_grad=True)
        self.opt = torch.optim.Adam(
            [{"params": [self.R], "lr": lr_R},
             {"params": [self.T], "lr": lr_T}],
            betas=ADAM_BETAS, capturable=dev.type == "cuda")
        # Its warm-up and eager iterations run outside a capture by design.
        self.opt._warned_capturable_if_run_uncaptured = True
        self.it = torch.zeros(1, dtype=torch.int64, device=dev)
        self.best_loss = torch.zeros((), device=dev)
        self.best_pose = torch.zeros(7, device=dev)
        self.losses = torch.zeros(iters, device=dev)
        self.poses = torch.zeros((iters, 7), device=dev)
        self.graph: CountedGraph | None = None

    @torch.no_grad()
    def load(self, quads, pose_init, px, draws) -> None:
        """The frame's inputs in place: the quads when they are other
        tensors than the last frame's (a new group's), the pixels, the
        jitter (``iters`` draws from ``draws``, in iteration order), and
        the start state (``reset``)."""
        if len(self.quad_src) != len(quads) or any(
                r() is not q for r, q in zip(self.quad_src, quads)):
            for dst, q in zip(self.quads, quads):
                dst.copy_(q)
            self.quad_src = tuple(weakref.ref(q) for q in quads)
        for dst, x in zip(self.px, px):
            dst.copy_(x)
        if self.jitter is not None:
            shape = tuple(self.jitter.shape[1:])
            for k in range(self.iters):
                self.jitter[k].copy_(draws.uniform(shape))
        self.reset(pose_init)

    @torch.no_grad()
    def reset(self, pose_init) -> None:
        """A fresh Adam from ``pose_init``: the pose, zero moments and
        steps (Adam makes its state at its first step), no best loss
        yet."""
        self.R.copy_(pose_init[:4])
        self.T.copy_(pose_init[4:])
        self.best_pose.copy_(pose_init)
        self.best_loss.fill_(float("inf"))
        self.it.zero_()
        for state in self.opt.state.values():
            for t in state.values():
                t.zero_()

    def body(self, ms: MapState) -> None:
        """Iteration ``it`` (see the class's docstring)."""
        it = self.it
        with trace.span("track.loss"):
            i, j, px_color, px_depth = (x.index_select(0, it)[0]
                                        for x in self.px)
            loss = self.loss_fn(self.R, self.T, ms, self.quads, i, j,
                                px_color, px_depth,
                                _SlotDraws(self.jitter, it))
        with trace.span("track.grad"):
            g_R, g_T = torch.autograd.grad(loss, [self.R, self.T])
            if self.sharded:
                g = distributed.all_reduce_(torch.cat([g_R, g_T]),
                                            "track_grad")
                g_R, g_T = g[:4], g[4:]
            self.R.grad, self.T.grad = g_R, g_T
        with trace.span("track.step"), torch.no_grad():
            pose = torch.cat([self.R, self.T])
            loss = loss.detach()
            self.best_pose.copy_(torch.where(loss < self.best_loss, pose,
                                             self.best_pose))
            self.best_loss.copy_(torch.minimum(loss, self.best_loss))
            self.losses.index_copy_(0, it, loss.reshape(1))
            self.poses.index_copy_(0, it, pose[None])
            self.opt.step()
            it.add_(1)

    def capture(self, ms: MapState) -> int:
        """Run the loaded frame's first iterations eagerly, then capture
        the body (``utils/graphs.CountedGraph``, which keeps the
        capture's K1/K2 launches for the replays); a capture runs
        nothing, so the frame goes on from there.  Returns the
        iterations run."""
        warm = min(WARMUP_ITERS, self.iters)

        def warm_up():
            for _ in range(warm):
                self.body(ms)

        self.graph = CountedGraph(self.R.device, warm_up,
                                  lambda: self.body(ms),
                                  (cuda_sample.LAUNCHES,))
        return warm


class TrackCore:
    """The per-frame optimization (``make_track_core``): the iteration
    body replayed or run eagerly (the module's docstring)."""

    def __init__(self, loss_fn, iters: int, lr_R: float, lr_T: float,
                 scene: SceneGeometry, sharded: bool):
        self.loss_fn = loss_fn
        self.iters = iters
        self.lr_R, self.lr_T = lr_R, lr_T
        # The renderer's one draw per iteration: the depth-guided jitter.
        self.perturb, self.n_samples = scene.perturb, scene.n_samples
        self.sharded = sharded
        self.static: StaticFrame | None = None
        self.static_key = None

    def __call__(self, ms: MapState, quads, pose_init, px_i, px_j, px_color,
                 px_depth, draws):
        px = (px_i, px_j, px_color, px_depth)
        key = (tuple((x.shape, x.dtype) for x in px),
               tuple((q.shape, q.dtype) for q in quads), pose_init.device,
               tuple(p.data_ptr() for p in ms.decoder.parameters()))
        if key != self.static_key:
            # The old buffers and graph pool go before the new ones come.
            self.static = self.static_key = None
            self.static = StaticFrame(
                self.loss_fn, self.iters, self.lr_R, self.lr_T,
                self.sharded, px, quads, pose_init,
                ((px_i.shape[1], self.n_samples) if self.perturb else None))
            self.static_key = key
        st = self.static
        st.load(quads, pose_init, px, draws)
        if not replayable(pose_init, self.sharded):
            for _ in range(self.iters):
                with trace.span("track.iter"):
                    st.body(ms)
            GRAPH_COUNTS["eager_iters"] += self.iters
        else:
            done = 0
            with torch.cuda.device(pose_init.device):
                if st.graph is None:
                    with trace.span("track.capture"):
                        done = st.capture(ms)
                    GRAPH_COUNTS["captures"] += 1
                    GRAPH_COUNTS["eager_iters"] += done
                for _ in range(self.iters - done):
                    with trace.span("track.iter"):
                        st.graph.replay()
            GRAPH_COUNTS["replays"] += self.iters - done
        return st.best_pose.clone(), st.losses.clone(), st.poses.clone()


def make_track_core(cfg: dict, scene: SceneGeometry, cam: Camera,
                    sharded: bool = False):
    """The per-frame optimization (``sharded``: over the process group's
    ranks, see the module's docstring).

    Returns core(ms, quads, pose_init (7,), px_i (iters, n),
    px_j (iters, n), px_color (iters, n, 3) uint8, px_depth (iters, n),
    draws) -> (best_pose (7,), losses (iters,), iter_poses (iters, 7)),
    all on the device, a ``TrackCore``.  ``quads`` are the frozen (sdf,
    color) quad atlases (``pack_tracking_quads``).
    """
    t = cfg["tracking"]
    iters = int(t["iters"])
    w_color, w_depth = float(t["w_color"]), float(t["w_depth"])
    w_fs, w_center, w_tail = (float(t["w_sdf_fs"]),
                              float(t["w_sdf_center"]),
                              float(t["w_sdf_tail"]))
    lr_T, lr_R = float(t["lr_T"]), float(t["lr_R"])

    weights = (w_fs, w_center, w_tail, w_color, w_depth)

    def loss_fn(R, T, ms, quads, i, j, px_color, px_depth, draws):
        c2w = cam_pose_to_matrix(torch.cat([R, T])[None])[0]
        valid = None
        if sharded:
            rank, world, n = (distributed.rank(), distributed.world(),
                              i.shape[0])
            rows = -(-n // world)
            i, j, px_color, px_depth = (rank_rows(x, rows, rank) for x in
                                        (i, j, px_color, px_depth))
            valid = (rank * rows + torch.arange(rows, device=i.device)) < n
            draws = RowShardDraws(draws, n, rank, world)
        i = i.to(torch.float32)
        j = j.to(torch.float32)
        px_color = px_color.to(torch.float32) * (1.0 / 255.0)
        rays_o, rays_d = rays_from_uv(i, j, c2w, cam.fx, cam.fy, cam.cx,
                                      cam.cy)
        t_exit = ray_aabb_exit_t(rays_o.detach(), rays_d.detach(),
                                 scene.bound_tensor(rays_o.device))
        inside = (t_exit >= px_depth) & (px_depth > 0)
        if valid is not None:
            inside = inside & valid
        depth, color, sdf, z_vals = render_rays(
            draws, ms, scene, rays_o, rays_d, px_depth, importance=False,
            sdf_quad=quads[0], color_quad=quads[1])
        err = torch.abs(px_depth - depth.detach())
        if not sharded:
            med = masked_median(err, inside)
            dmask = inside & (err < 10.0 * med)
            loss = sdf_losses(sdf, z_vals, px_depth, dmask,
                              scene.truncation, w_fs, w_center, w_tail)
            loss = loss + w_color * color_loss(px_color, color, dmask)
            loss = loss + w_depth * depth_loss(px_depth, depth, dmask)
            return loss
        both = distributed.all_gather(
            torch.stack([err, inside.to(err.dtype)]), "track_median")
        med = masked_median(both[:, 0].reshape(-1),
                            both[:, 1].reshape(-1) > 0)
        dmask = inside & (err < 10.0 * med)
        return global_weighted_loss(
            slam_terms(sdf, z_vals, px_depth, dmask, scene.truncation,
                       px_color, color, dmask, depth, dmask), weights,
            lambda t: distributed.all_reduce_(t, "track_loss"))

    return TrackCore(loss_fn, iters, lr_R, lr_T, scene, sharded)


@torch.no_grad()
def pack_tracking_quads(ms: MapState, scene: SceneGeometry, map_bf16: bool):
    """The frozen map's (sdf, color) quad atlases, packed once per group
    of tracked frames; bfloat16 by default (tracking.map_bf16), halving
    the sample's row reads."""
    dtype = torch.bfloat16 if map_bf16 else torch.float32
    return (pack_quad(ms.sdf_atlas, scene.sdf_layout).to(dtype),
            pack_quad(ms.color_atlas, scene.color_layout).to(dtype))


def make_tracker(cfg: dict, scene: SceneGeometry, cam: Camera,
                 sharded: bool = False):
    """Single-frame tracking: pack the quads, run the optimization core.

    Returns track(ms, pose_init (7,), px_i (iters, n), px_j, px_color,
    px_depth, draws) -> (best_pose (7,), losses (iters,), iter_poses
    (iters, 7)).  ``sharded`` as in make_track_core."""
    map_bf16 = bool(cfg["tracking"].get("map_bf16", True))
    core = make_track_core(cfg, scene, cam, sharded)

    def track(ms, pose_init, px_i, px_j, px_color, px_depth, draws):
        quads = pack_tracking_quads(ms, scene, map_bf16)
        return core(ms, quads, pose_init, px_i, px_j, px_color, px_depth,
                    draws)

    return track


def make_frame_tracker(cfg: dict, scene: SceneGeometry, cam: Camera,
                       sharded: bool = False):
    """Whole-frame tracking: the constant-speed start from the
    trajectory, the optimization, the trajectory write-back (a group of
    one frame, make_group_tracker).

    Returns track_frame(ms, est (n, 4, 4) [row idx written], idx, px_i
    (iters, n), px_j, px_color, px_depth, draws) -> (c2w (4, 4),
    loss_first, loss_best, iter_poses (iters, 7))."""
    group = make_group_tracker(cfg, scene, cam, sharded)

    def track_frame(ms, est, idx, px_i, px_j, px_color, px_depth, draws):
        c2ws, first, best, iter_poses = group(
            ms, est, idx, px_i[None], px_j[None], px_color[None],
            px_depth[None], draws)
        return c2ws[0], first[0], best[0], iter_poses[0]

    return track_frame


def make_group_tracker(cfg: dict, scene: SceneGeometry, cam: Camera,
                       sharded: bool = False):
    """Track a group of consecutive frames against one frozen map
    (``sharded`` as in make_track_core).

    Between two mapped frames the map does not change, so the group
    packs its quads once.  Frame idx0's pose starts from the
    constant-speed extrapolation of est[idx0-1] and est[idx0-2] (or
    est[idx0-1] alone for frame 1); each later frame of the group
    extrapolates from the best poses its two predecessors just produced.
    A group of one frame is exactly the per-frame tracker.

    Returns track_group(ms, est (n, 4, 4) [written in place at
    idx0..idx0+G-1], idx0, px_i (G, iters, n), px_j, px_color,
    px_depth, draws) -> (c2ws (G, 4, 4), loss_first (G,), loss_best (G,),
    iter_poses (G, iters, 7)): each iteration's pre-update pose, what the
    tracking panels render.
    """
    t = cfg["tracking"]
    const_speed = bool(t.get("const_speed_assumption", True))
    map_bf16 = bool(t.get("map_bf16", True))
    core = make_track_core(cfg, scene, cam, sharded)

    def track_group(ms, est, idx0, px_i, px_j, px_color, px_depth, draws):
        with trace.span("track.pack"):
            quads = pack_tracking_quads(ms, scene, map_bf16)
        prev = matrix_to_cam_pose(est[idx0 - 1])
        prev_prev = (matrix_to_cam_pose(est[idx0 - 2]) if idx0 >= 2
                     else prev)
        poses, loss_first, loss_best, iter_poses = [], [], [], []
        for g in range(px_i.shape[0]):
            pose_init = 2.0 * prev - prev_prev if const_speed else prev
            best, losses, it_poses = core(ms, quads, pose_init, px_i[g],
                                          px_j[g], px_color[g], px_depth[g],
                                          draws)
            poses.append(best)
            loss_first.append(losses[0])
            loss_best.append(losses.min())
            iter_poses.append(it_poses)
            prev_prev, prev = prev, best
        c2ws = cam_pose_to_matrix(torch.stack(poses))
        est[idx0:idx0 + len(poses)] = c2ws
        return (c2ws, torch.stack(loss_first), torch.stack(loss_best),
                torch.stack(iter_poses))

    return track_group
