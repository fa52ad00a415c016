"""Mapping: windowed bundle adjustment of atlases, decoders and poses.

The port of ``myslam_tpu.engine.mapper``'s single-device frame mappers,
run eagerly: ``make_frame_mapper`` over a device or packed keyframe
store, ``make_window_frame_mapper`` over the host-staged store's device
line cache.  The keyframe window is described by slot arrays:

  * the window has w_max slots; slot i holds an index into the keyframe
    store's imagery (the current frame sits in the scratch slot);
  * the per-iteration ray budget is split round-robin over the active
    slots (ray r reads from slot r % n_slots);
  * pose freezing (the oldest window frame; all frames when joint_opt is
    off) is a per-slot 0/1 mask applied by detaching.

A fresh Adam per mapped frame, with the reference's per-group learning
rates (decoders, planes, c_planes, poses); beta is frozen when
``rendering.learnable_beta`` is off; ``lr_factor`` scales the map
groups only.

``sharded``: ray data parallelism over the ranks of the process group
(``parallel/distributed.py``).  Every rank keeps its contiguous slice of
``ceil(pixels / R)`` rays, the padded tail masked out; the masked means
are global (one all-reduce of their sums and counts) and the gradients of
the atlases, decoders and window poses are summed as one flat buffer in
one all-reduce per iteration, before Adam.  The draws follow
``parallel.dp_impl``, as the JAX package's two ray DPs draw:

  * ``shardmap`` (its ``dp_mesh``): every rank draws the whole padded
    batch (``ceil(pixels / R) * R`` rays); the renderer's draws are the
    local batch's, the same on every rank, as each JAX shard's are;
  * ``spmd`` (``spmd=True``; its ``ray_sharding`` constraint): every
    rank draws the ``pixels`` rays one device draws, and the renderer's
    draws are the global batch's, sliced by rank (``RowShardDraws``), so
    the ranks together take one device's draws and its gradient.

``zero_opt`` (``dp_impl: spmd`` with ``parallel.zero_opt``): ZeRO-1, the
port of ``make_row_sharder``.  Adam's moments of every atlas of at least
``min_rows`` rows (``ZERO_MIN_ROWS``, JAX's 4,096) are row-sharded: each
rank receives its block of rows of the summed gradient
(``distributed.reduce_grads_rows``), updates those rows alone, and the
updated rows are all-gathered into the replicated atlas before the next
forward (``distributed.all_gather_rows``); the decoders and the window
poses stay replicated.  The update is elementwise, so it equals the
replicated one.  The optimizer is built fresh for each mapped frame, so
no sharded moment outlives the frame or reaches a checkpoint.  One rank
is exactly the unsharded path.

``make_frame_mapper`` runs every frame that is not ``sharded`` through
one iteration body over fixed buffers (``StaticMap.body``: the loss and
its backward, the draws read from slots the host fills before each
iteration in the eager loop's order), with Adam's step a Python call
after each iteration (``MapGraph``).  How the body runs is chosen by
what the call can observe (``replayable``), never by a setting:

  * replayed, on a CUDA device over the default map backend (no
    ``queries_factory``), while the sample's entry points are
    ``cuda_sample``'s own (``tracker.replayable``'s test) and no
    ``vis_hook`` is given for the frame: the body is captured once as a
    CUDA graph and replayed;
  * eager otherwise: Python launches every operation of every
    iteration.  That covers CPU tensors, map shards' banded backend, a
    replaced sample entry point (a graph replays only the kernels its
    capture saw, so a recorder of K1's and K2's calls would see the
    capture's alone) and frames with panels.

The ``sharded`` frame mappers, ``make_mapper`` and
``make_window_frame_mapper`` (the host-staged store's) run the eager
loop ``_iterate`` instead, whose steps cross the ranks.

``GRAPH_COUNTS`` counts captures, replayed iterations and iterations run
eagerly (a capturing frame's first ones among them) by this module's
mappers.  A replay adds the K1/K2 launches and the importance branch's
passes that its capture recorded to ``cuda_sample.LAUNCHES`` and
``renderer.IMPORTANCE_COUNTS``, and a capture takes its own back, so the
counters still count every run on the device.

Spans (``utils/trace.py``): ``map.select`` (the scratch write and the
window's pick), per iteration ``map.iter``, holding ``map.loss``,
``map.backward`` and ``map.step`` when the iteration runs eagerly and
the launch of one replay and ``map.step`` when it is replayed;
``map.capture`` around a capture and the eager iterations before it;
and ``map.writeback`` (the window's poses back to the store).
"""

from __future__ import annotations

import torch

from myslam_torch.core.geometry import ray_aabb_exit_t, rays_from_uv
from myslam_torch.core.losses import color_loss, depth_loss, \
    global_weighted_loss, sdf_losses, slam_terms
from myslam_torch.core.quaternion import cam_pose_to_matrix, \
    matrix_to_cam_pose
from myslam_torch.core.sampling import RowShardDraws, rank_rows
from myslam_torch.engine import tracker
from myslam_torch.engine.camera import Camera
from myslam_torch.engine.keyframes import KeyframeStore
from myslam_torch.models.planes import MapState
from myslam_torch.ops import cuda_sample
from myslam_torch.ops.pixel_gather import gather_rgb, gather_scalar, \
    gather_u16
from myslam_torch.parallel import distributed
from myslam_torch.render.renderer import IMPORTANCE_COUNTS, SceneGeometry, \
    make_queries, render_core
from myslam_torch.utils import trace
from myslam_torch.utils.graphs import CountedGraph


# Atlases of at least this many rows have their Adam moments row-sharded
# under ``zero_opt`` (the JAX package's ``make_row_sharder`` default).
ZERO_MIN_ROWS = 4096
# Bytes of Adam's moments of the atlases on this rank in the last mapped
# frame, and what a replicated Adam holds (chip_smoke.py reads them).
ADAM_BYTES = {"atlas_moments": 0, "atlas_moments_replicated": 0}
# A capturing frame's first iterations, run eagerly on a side stream
# before the capture (``StaticMap.capture``).
WARMUP_ITERS = 2
# How often mapping took each path (see the module's docstring).
GRAPH_COUNTS = {"captures": 0, "replays": 0, "eager_iters": 0}
# The host counters a captured iteration adds to and a replay must too.
_REPLAYED_COUNTERS = (cuda_sample.LAUNCHES, IMPORTANCE_COUNTS)


def map_quad_dtype(cfg: dict):
    """The quads' read precision of the mapping loss (mapping.map_bf16):
    torch.bfloat16, or None for the atlases' float32."""
    return (torch.bfloat16 if bool(cfg["mapping"].get("map_bf16", False))
            else None)


def _build_stages(cfg: dict, scene: SceneGeometry, cam: Camera,
                  packed: bool = False, sharded: bool = False,
                  spmd: bool = False):
    """The mapping loss's first and last stages, around render_core
    (``sharded``: this rank's slice of the rays, global means; ``spmd``:
    the draws one device makes, see the module's docstring).

    Returns (geometry, losses):
      geometry(poses, pose_mask, slot_kf, n_slots, kf_colors, kf_depths,
               kf_inv_q, draws) -> (rays_o, rays_d, px_depth, px_color,
               inside): the pixel draw and reads, and the rays;
      losses(sdf, z_vals, depth, color, px_depth, px_color, inside) ->
               the weighted loss.
    ``packed``: the imagery is the wire format, color uint8 and depth
    uint16 with a float32 scale per slot (``kf_inv_q``); only the sampled
    pixels are dequantized."""
    m = cfg["mapping"]
    n_rays = int(m["pixels"])
    w_color, w_depth = float(m["w_color"]), float(m["w_depth"])
    w_fs, w_center, w_tail = (float(m["w_sdf_fs"]),
                              float(m["w_sdf_center"]),
                              float(m["w_sdf_tail"]))
    HW = cam.H * cam.W
    weights = (w_fs, w_center, w_tail, w_color, w_depth)

    def geometry(poses, pose_mask, slot_kf, n_slots, kf_colors, kf_depths,
                 kf_inv_q, draws):
        """Draws, in order: pixel columns, pixel rows (``randint``), of
        the whole batch (padded to the ranks under shardmap)."""
        dev = poses.device
        poses = torch.where(pose_mask[:, None] > 0, poses, poses.detach())
        c2ws = cam_pose_to_matrix(poses)
        world, rank = distributed.world(), distributed.rank()
        rows = -(-n_rays // world) if sharded else n_rays
        n_draw = n_rays if spmd or not sharded else rows * world
        slot_of_ray = torch.arange(n_draw, device=dev) % n_slots
        i = draws.randint((n_draw,), 0, cam.W).to(torch.float32)
        j = draws.randint((n_draw,), 0, cam.H).to(torch.float32)
        pad_ok = None
        if sharded:
            i, j, slot_of_ray = (rank_rows(x, rows, rank)
                                 for x in (i, j, slot_of_ray))
            if rows * world != n_rays:
                pad_ok = (rank * rows
                          + torch.arange(rows, device=dev)) < n_rays
        kf_of_ray = slot_kf[slot_of_ray]
        flat = kf_of_ray * HW + j.long() * cam.W + i.long()
        if packed:
            px_depth = (gather_u16(kf_depths, flat).to(torch.float32)
                        * kf_inv_q[kf_of_ray])
            px_color = (gather_rgb(kf_colors, flat).to(torch.float32)
                        * (1.0 / 255.0))
        else:
            px_depth = gather_scalar(kf_depths, flat)
            px_color = gather_rgb(kf_colors, flat).to(torch.float32)
        rays_o, rays_d = rays_from_uv(i, j, c2ws[slot_of_ray], cam.fx,
                                      cam.fy, cam.cx, cam.cy)
        t_exit = ray_aabb_exit_t(rays_o.detach(), rays_d.detach(),
                                 scene.bound_tensor(dev))
        inside = t_exit >= px_depth  # depth-0 rays pass, as the reference
        if pad_ok is not None:
            inside = inside & pad_ok  # padded tail rays contribute zero
        return rays_o, rays_d, px_depth, px_color, inside

    def losses(sdf, z_vals, depth, color, px_depth, px_color, inside):
        dmask = inside & (px_depth > 0)
        if sharded:
            return global_weighted_loss(
                slam_terms(sdf, z_vals, px_depth, dmask, scene.truncation,
                           px_color, color, inside, depth, dmask), weights,
                lambda t: distributed.all_reduce_(t, "loss"))
        loss = sdf_losses(sdf, z_vals, px_depth, dmask, scene.truncation,
                          w_fs, w_center, w_tail)
        loss = loss + w_color * color_loss(px_color, color, inside)
        loss = loss + w_depth * depth_loss(px_depth, depth, dmask)
        return loss

    return geometry, losses


def make_map_optimizer(cfg: dict, ms: MapState, poses, lr_factor: float):
    """Adam over the reference's groups: decoders (beta too when
    ``rendering.learnable_beta``), planes, c_planes at their rates times
    ``lr_factor``, and the poses at ``joint_opt_cam_lr`` (``poses`` None:
    no pose group)."""
    m = cfg["mapping"]
    lr = m["lr"]
    dec = ms.decoder
    dec_params = dec.mlp_params() + (
        [dec.beta] if bool(cfg["rendering"].get("learnable_beta", True))
        else [])
    groups = [
        {"params": dec_params, "lr": float(lr["decoders_lr"]) * lr_factor},
        {"params": [ms.sdf_atlas], "lr": float(lr["planes_lr"]) * lr_factor},
        {"params": [ms.color_atlas],
         "lr": float(lr["c_planes_lr"]) * lr_factor}]
    if poses is not None:
        groups.append({"params": [poses],
                       "lr": float(m["joint_opt_cam_lr"])})
    return torch.optim.Adam(groups)


def _build_core(cfg: dict, scene: SceneGeometry, cam: Camera,
                importance: bool = True, packed: bool = False,
                sharded: bool = False, queries_factory=None,
                spmd: bool = False):
    """The per-iteration mapping loss and the optimizer factory.

    The loss runs _build_stages' geometry, render_core over the map's
    quads (packed here each iteration, at ``map_quad_dtype``), then
    _build_stages' losses; ``packed``, ``sharded`` and ``spmd`` as
    there (under ``spmd`` the renderer takes this rank's rows of the
    global batch's draws).
    ``queries_factory(ms) -> FieldQueries`` replaces the map backend the
    loss renders against (the banded one of
    ``parallel/sharded_engine.py``), as the JAX package's ``_build_core``
    takes one."""
    quad_dtype = map_quad_dtype(cfg)
    geometry, losses = _build_stages(cfg, scene, cam, packed, sharded,
                                     spmd)
    n_rays = int(cfg["mapping"]["pixels"])
    if queries_factory is None:
        def queries_factory(ms):
            return make_queries(ms, scene, quad_dtype=quad_dtype)

    def make_optimizer(ms: MapState, poses: torch.Tensor, lr_factor: float):
        return make_map_optimizer(cfg, ms, poses, lr_factor)

    def loss_fn(ms: MapState, poses, pose_mask, slot_kf, n_slots,
                kf_colors, kf_depths, kf_inv_q, draws):
        """One iteration's loss.  Draws, in order: geometry's, then the
        renderer's (build_z_vals_core)."""
        rays_o, rays_d, px_depth, px_color, inside = geometry(
            poses, pose_mask, slot_kf, n_slots, kf_colors, kf_depths,
            kf_inv_q, draws)
        if sharded and spmd:
            draws = RowShardDraws(draws, n_rays, distributed.rank(),
                                  distributed.world())
        depth, color, sdf, z_vals = render_core(
            draws, scene, rays_o, rays_d, px_depth, importance,
            queries_factory(ms))
        return losses(sdf, z_vals, depth, color, px_depth, px_color, inside)

    return loss_fn, make_optimizer


def optimizer_params(opt: torch.optim.Optimizer) -> list:
    """The optimizer's parameters, group by group: the order of the flat
    gradient buffer that crosses the ranks."""
    return [p for g in opt.param_groups for p in g["params"]]


class RowShardedAdam:
    """ZeRO-1 over the ranks of the current group: ``opt`` (a fresh Adam
    of ``make_map_optimizer``) with each parameter of at least
    ``min_rows`` rows (2-D: the atlases) replaced in its group by this
    rank's block of rows (``distributed.host_shard``), a tensor of its
    own, so that Adam keeps moments for those rows alone.  ``step()``
    takes the gradients the backward left on the full parameters."""

    def __init__(self, opt: torch.optim.Optimizer,
                 min_rows: int = ZERO_MIN_ROWS):
        self.opt = opt
        self.params = optimizer_params(opt)
        self.own = {}
        for g in opt.param_groups:
            for k, p in enumerate(g["params"]):
                if p.dim() == 2 and p.shape[0] >= min_rows:
                    lo, hi = distributed.host_shard(p.shape[0])
                    self.own[p] = p.detach()[lo:hi].clone()
                    g["params"][k] = self.own[p]
        self.sharded = [p in self.own for p in self.params]

    def zero_grad(self) -> None:
        """Drop the gradients of the full parameters (the backward's) and
        of the row blocks."""
        for p in self.params:
            p.grad = None
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Reduce the gradients (this rank's rows of the sharded ones),
        update, and all-gather the updated rows into the full atlases."""
        grads = distributed.reduce_grads_rows(self.params, self.sharded)
        for p, s, g in zip(self.params, self.sharded, grads):
            if s:
                self.own[p].grad = g
            else:
                p.grad = g
        self.opt.step()
        fulls = [p for p, s in zip(self.params, self.sharded) if s]
        distributed.all_gather_rows(fulls, [self.own[p] for p in fulls])

    def moment_bytes(self) -> tuple[int, int]:
        """Bytes of Adam's moments of the sharded parameters on this
        rank, and what the replicated Adam keeps for them."""
        own = sum(t.numel() * t.element_size()
                  for p, o in self.own.items()
                  for t in self.opt.state[o].values()
                  if isinstance(t, torch.Tensor) and t.dim() > 0)
        full = sum(2 * p.numel() * p.element_size() for p in self.own)
        return own, full


@torch.no_grad()
def _show(vis_hook, it: int, ms: MapState, poses, n_slots) -> None:
    """``vis_hook`` before iteration ``it``: the map and the current
    frame's pose (slot ``n_slots - 1`` of ``poses``)."""
    cur = torch.as_tensor(n_slots, device=poses.device)
    pose = poses.detach().index_select(0, cur.reshape(1) - 1)
    vis_hook(it, ms, cam_pose_to_matrix(pose)[0])


def _iterate(loss_fn, make_optimizer, ms: MapState, poses, pose_mask,
             lines, n_slots, imagery, draws, iters: int, lr_factor: float,
             sharded: bool, vis_hook=None, vis_every: int = 1,
             zero_opt: bool = False, min_rows: int = ZERO_MIN_ROWS):
    """``iters`` Adam steps of the map and the window poses (updated in
    place); under ``sharded`` the gradients cross the ranks in one
    all-reduce per step, or with ``zero_opt`` (more than one rank) by the
    row-sharded Adam.  Returns the losses (iters,) on the device."""
    opt = make_optimizer(ms, poses, lr_factor)
    params = optimizer_params(opt)
    zero = (RowShardedAdam(opt, min_rows)
            if sharded and zero_opt and distributed.world() > 1 else None)
    losses = []
    for it in range(iters):
        if vis_hook is not None and it > 0 and it % vis_every == 0:
            _show(vis_hook, it, ms, poses, n_slots)
        with trace.span("map.iter"):
            (zero or opt).zero_grad()
            with trace.span("map.loss"):
                loss = loss_fn(ms, poses, pose_mask, lines, n_slots,
                               *imagery, draws)
            with trace.span("map.backward"):
                loss.backward()
            with trace.span("map.step"):
                if zero is not None:
                    zero.step()
                else:
                    if sharded:
                        distributed.all_reduce_grads(params)
                    opt.step()
            losses.append(loss.detach())
    GRAPH_COUNTS["eager_iters"] += iters
    if zero is not None:
        own, full = zero.moment_bytes()
        ADAM_BYTES.update(atlas_moments=own, atlas_moments_replicated=full)
    return torch.stack(losses) if losses else torch.zeros(
        (0,), device=poses.device)


def replayable(t: torch.Tensor, sharded: bool, own_queries: bool,
               vis_hook=None) -> bool:
    """Whether a frame's iterations replay one captured graph: ``t`` on a
    CUDA device, without collectives (not ``sharded``) and with the
    sample's entry points not replaced (``tracker.replayable``), over the
    default map backend (``own_queries``), and with no panels
    (``vis_hook`` None)."""
    return (tracker.replayable(t, sharded) and own_queries
            and vis_hook is None)


class _DrawProbe:
    """Passes a draw source's draws through and notes each call: the
    schedule of one iteration's draws (kind, shape, range), and the
    draws."""

    def __init__(self, base):
        self.base = base
        self.calls: list = []
        self.drawn: list = []

    def uniform(self, shape) -> torch.Tensor:
        t = self.base.uniform(shape)
        self.calls.append(("uniform", tuple(shape), None, None))
        self.drawn.append(t)
        return t

    def randint(self, shape, low: int, high: int) -> torch.Tensor:
        t = self.base.randint(shape, low, high)
        self.calls.append(("randint", tuple(shape), int(low), int(high)))
        self.drawn.append(t)
        return t


class _SlotDraws:
    """The iteration body's draw source: the slots the host filled for
    the iteration, served in the schedule's order.  A draw of another
    kind, shape or range than the schedule's next one, or past its end,
    raises; so does ``done`` before the schedule's end."""

    __slots__ = ("schedule", "slots", "next")

    def __init__(self, schedule, slots):
        self.schedule, self.slots, self.next = schedule, slots, 0

    def _take(self, call) -> torch.Tensor:
        k = self.next
        want = self.schedule[k] if k < len(self.schedule) else None
        if call != want:
            raise ValueError(f"the mapping iteration drew {call}; its slot "
                             f"{k} holds {want}")
        self.next = k + 1
        return self.slots[k]

    def uniform(self, shape) -> torch.Tensor:
        return self._take(("uniform", tuple(shape), None, None))

    def randint(self, shape, low: int, high: int) -> torch.Tensor:
        return self._take(("randint", tuple(shape), int(low), int(high)))

    def done(self) -> None:
        if self.next != len(self.schedule):
            raise ValueError(f"the mapping iteration drew {self.next} of "
                             f"its {len(self.schedule)} slots")


class StaticMap:
    """One mapper's iteration over fixed buffers: what the body reads and
    writes, and so what a captured graph of it replays.

    ``body`` runs iteration ``it`` (a device int64 index) of the loaded
    frame from the buffers alone: the window's pose leaf ``poses``
    (w_max, 7), ``pose_mask``, the imagery rows ``lines`` and ``n_slots``
    (0-dim), each copied in per frame (``load``); the store's imagery,
    preallocated and so at a fixed address; the map's atlases and
    decoders, which Adam updates in place; the iteration's draws, from
    the slots (``fill``).  It writes the loss into row ``it`` of
    ``losses``, the gradients of ``params`` (the frame optimizer's
    parameters, in its order) as their ``.grad``, and ``it + 1``.  A
    capture's gradients are the graph's outputs, which each replay
    rewrites in place; ``load`` points the parameters' ``.grad`` at
    them."""

    def __init__(self, loss_fn, imagery, w_max: int, rows: int, device):
        self.loss_fn = loss_fn
        self.imagery = imagery
        self.poses = torch.zeros((w_max, 7), device=device,
                                 requires_grad=True)
        self.pose_mask = torch.zeros(w_max, device=device)
        self.lines = torch.zeros(w_max, dtype=torch.int64, device=device)
        self.n_slots = torch.zeros((), dtype=torch.int64, device=device)
        self.losses = torch.zeros(rows, device=device)
        self.it = torch.zeros(1, dtype=torch.int64, device=device)
        self.params: list = []
        # One iteration's draws: (kind, shape, low, high) in call order,
        # from the first iteration these buffers run, and their slots.
        self.schedule: list | None = None
        self.slots: list = []
        self.graph: CountedGraph | None = None

    @torch.no_grad()
    def load(self, c2ws, pose_mask, lines, n_slots) -> None:
        """A frame's window in place: the start poses of ``c2ws`` (w_max,
        4, 4), the pose mask, the imagery rows, the slot count; row 0 for
        the first loss; the graph's gradients as the ``.grad`` of the
        parameters (an eager frame in between may have dropped them)."""
        self.poses.copy_(matrix_to_cam_pose(c2ws))
        self.pose_mask.copy_(pose_mask)
        self.lines.copy_(lines)
        self.n_slots.copy_(torch.as_tensor(n_slots))
        self.it.zero_()
        if self.graph is not None:
            for p, g in zip(self.params, self.graph.out):
                p.grad = g

    @torch.no_grad()
    def fill(self, draws) -> None:
        """The iteration's draws from ``draws``, made as the eager loop
        makes them (the schedule's calls in its order), into the slots."""
        for (kind, shape, low, high), slot in zip(self.schedule,
                                                  self.slots):
            slot.copy_(draws.uniform(shape) if kind == "uniform"
                       else draws.randint(shape, low, high))

    def body(self, ms: MapState, draws) -> tuple:
        """Iteration ``it`` (see the class's docstring); returns the
        gradients."""
        with trace.span("map.loss"):
            loss = self.loss_fn(ms, self.poses, self.pose_mask, self.lines,
                                self.n_slots, *self.imagery, draws)
        with trace.span("map.backward"):
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
            for p, g in zip(self.params, grads):
                p.grad = g
            with torch.no_grad():
                self.losses.index_copy_(0, self.it, loss.detach().reshape(1))
                self.it.add_(1)
        return grads

    def iterate(self, ms: MapState, draws, step) -> None:
        """One iteration run eagerly: the body on the iteration's draws
        (the first iteration of these buffers takes them through a probe
        that notes the schedule, later ones from the slots), then
        ``step``."""
        with trace.span("map.iter"):
            if self.schedule is None:
                probe = _DrawProbe(draws)
                self.body(ms, probe)
                self.schedule = probe.calls
                self.slots = [torch.empty_like(t) for t in probe.drawn]
            else:
                self.fill(draws)
                slots = _SlotDraws(self.schedule, self.slots)
                self.body(ms, slots)
                slots.done()
            with trace.span("map.step"):
                step()

    def capture(self, ms: MapState, draws, step, warm: int) -> None:
        """Run the frame's first ``warm`` iterations eagerly (they set up
        the draw slots too), then capture the body
        (``utils/graphs.CountedGraph``, which keeps what the capture
        added to ``_REPLAYED_COUNTERS`` for the replays); a capture runs
        nothing, so the frame goes on from there."""

        def warm_up():
            for _ in range(warm):
                self.iterate(ms, draws, step)

        def capture_body():
            slots = _SlotDraws(self.schedule, self.slots)
            grads = self.body(ms, slots)
            slots.done()
            return grads

        self.graph = CountedGraph(self.poses.device, warm_up, capture_body,
                                  _REPLAYED_COUNTERS)


class MapGraph:
    """A frame mapper's iterations over ``StaticMap``'s buffers, a fresh
    Adam (``make_optimizer``) per frame whose step is a Python call after
    each iteration: replayed from a graph captured at the mapper's first
    replayable frame, or run eagerly (``replay`` False, see the module's
    docstring).  The buffers and the graph are made again when the
    window's size, or the storage or identity of an atlas, a decoder
    parameter or the imagery change (a resume, a checkpoint load), or
    when a frame has more iterations than the losses have rows.  The
    pixel count, the importance branch and the quads' dtype are the
    mapper's own, and each mapper holds its graph: a run captures once
    per mapper."""

    def __init__(self, loss_fn, make_optimizer):
        self.loss_fn = loss_fn
        self.make_optimizer = make_optimizer
        self.static: StaticMap | None = None
        self.key = None

    def __call__(self, ms: MapState, c2ws, pose_mask, lines, n_slots,
                 imagery, draws, iters: int, lr_factor: float, replay: bool,
                 vis_hook=None, vis_every: int = 1):
        """``iters`` steps from the window's poses ``c2ws`` (w_max, 4, 4);
        ``vis_hook`` and ``vis_every`` as ``_optimize_window``'s (an eager
        frame's alone).  Returns the pose leaf (w_max, 7) after the last
        step and the losses (iters,), a copy of the buffer's rows."""
        dev = c2ws.device
        leaves = [ms.sdf_atlas, ms.color_atlas, *ms.decoder.parameters(),
                  *(t for t in imagery if t is not None)]
        key = (dev, c2ws.shape[0],
               tuple((id(t), t.data_ptr()) for t in leaves))
        if key != self.key or iters > self.static.losses.shape[0]:
            # The old buffers and graph pool go before the new ones come.
            self.static = self.key = None
            self.static = StaticMap(self.loss_fn, imagery, c2ws.shape[0],
                                    max(iters, 1), dev)
            self.key = key
        st = self.static
        st.load(c2ws, pose_mask, lines, n_slots)
        opt = self.make_optimizer(ms, st.poses, lr_factor)
        params = optimizer_params(opt)
        if st.graph is None:
            st.params = params
        elif len(params) != len(st.params) or any(
                a is not b for a, b in zip(params, st.params)):
            raise RuntimeError("the mapping optimizer's parameters are not "
                               "the captured graph's")
        if not replay:
            for it in range(iters):
                if vis_hook is not None and it > 0 and it % vis_every == 0:
                    _show(vis_hook, it, ms, st.poses, st.n_slots)
                st.iterate(ms, draws, opt.step)
            GRAPH_COUNTS["eager_iters"] += iters
        else:
            done = 0
            with torch.cuda.device(dev):
                if st.graph is None:
                    done = min(WARMUP_ITERS, iters)
                    if iters > done:
                        with trace.span("map.capture"):
                            st.capture(ms, draws, opt.step, done)
                        GRAPH_COUNTS["captures"] += 1
                    else:
                        for _ in range(done):
                            st.iterate(ms, draws, opt.step)
                    GRAPH_COUNTS["eager_iters"] += done
                for _ in range(iters - done):
                    with trace.span("map.iter"):
                        st.fill(draws)
                        st.graph.replay()
                        with trace.span("map.step"):
                            opt.step()
            GRAPH_COUNTS["replays"] += iters - done
        return st.poses, st.losses[:iters].clone()


def _optimize_window(loss_fn, make_optimizer, ms: MapState, store, est,
                     c2ws, pose_mask, slot_kf, lines, n_slots, imagery,
                     idx: int, draws, iters: int, lr_factor: float,
                     joint_opt: bool, vis_hook=None, vis_every: int = 1,
                     sharded: bool = False, zero_opt: bool = False,
                     min_rows: int = ZERO_MIN_ROWS, graph=None,
                     replay: bool = False):
    """The iterations over one window, then the masked pose write-back.

    ``c2ws`` (w_max, 4, 4) are the window's starting poses, ``slot_kf``
    its global store slots (where the poses go back), ``lines`` the
    imagery rows the rays read (``imagery``: colors, depths, inv_q).
    ``sharded``, ``zero_opt`` and ``min_rows`` as _iterate's.
    ``vis_hook(m, ms, c2w)``, when given, is called before iteration m's
    step for every multiple m of ``vis_every`` with 0 < m < iters, with
    the map after m iterations and the current frame's pose (slot
    n_slots - 1); without it the loop reads nothing back.  ``graph`` (a
    ``MapGraph``): the iterations run there, replayed or (``replay``
    False) eagerly, instead of in ``_iterate``.
    Returns the losses (iters,) on the device."""
    if graph is not None:
        poses, losses = graph(ms, c2ws, pose_mask, lines, n_slots, imagery,
                              draws, iters, lr_factor, replay, vis_hook,
                              vis_every)
    else:
        poses = matrix_to_cam_pose(c2ws).requires_grad_()
        losses = _iterate(loss_fn, make_optimizer, ms, poses, pose_mask,
                          lines, n_slots, imagery, draws, iters, lr_factor,
                          sharded, vis_hook, vis_every, zero_opt, min_rows)
    with torch.no_grad(), trace.span("map.writeback"):
        # Keyframe poses of the optimized window slots; the trajectory
        # only for the current frame, under joint_opt.
        c2ws_out = cam_pose_to_matrix(poses)
        old = store.est_c2w[slot_kf]
        store.est_c2w[slot_kf] = torch.where(
            pose_mask[:, None, None] > 0, c2ws_out, old)
        if joint_opt:
            est[idx] = c2ws_out[n_slots - 1]
    return losses


def make_mapper(cfg: dict, scene: SceneGeometry, cam: Camera,
                importance: bool = True, sharded: bool = False,
                spmd: bool = False, zero_opt: bool = False,
                min_rows: int = ZERO_MIN_ROWS):
    """The bare BA step over a window the caller describes (the port of
    ``myslam_tpu.engine.mapper.make_mapper``), on a float store's
    imagery; ``sharded``: ray data parallelism, with the ``spmd`` draws
    and the row-sharded Adam (``zero_opt``, atlases of at least
    ``min_rows`` rows) of the module's docstring.

    Returns map_step(ms, poses (W, 7), pose_mask (W,), slot_kf (W,),
    n_slots, kf_colors, kf_depths, draws, *, iters, lr_factor) ->
    (poses (W, 7), losses (iters,)); ``ms`` is updated in place, the
    caller's ``poses`` are not.  Draws: each iteration's (``loss_fn``).
    """
    loss_fn, make_optimizer = _build_core(cfg, scene, cam, importance,
                                          sharded=sharded, spmd=spmd)

    def map_step(ms: MapState, poses, pose_mask, slot_kf, n_slots,
                 kf_colors, kf_depths, draws, *, iters: int,
                 lr_factor: float):
        poses = poses.detach().clone().requires_grad_()
        losses = _iterate(loss_fn, make_optimizer, ms, poses, pose_mask,
                          slot_kf, n_slots, (kf_colors, kf_depths, None),
                          draws, iters, lr_factor, sharded,
                          zero_opt=zero_opt, min_rows=min_rows)
        return poses.detach(), losses

    return map_step


def make_frame_mapper(cfg: dict, scene: SceneGeometry, cam: Camera,
                      selector, w_max: int, scratch_slot: int,
                      importance: bool = True, packed: bool = False,
                      sharded: bool = False, queries_factory=None,
                      spmd: bool = False, zero_opt: bool = False,
                      min_rows: int = ZERO_MIN_ROWS):
    """One mapped frame: scratch-imagery write, window selection, the
    iterations, masked pose write-back and keyframe admission, over a
    device store or (``packed``) a packed one; ``sharded``: ray data
    parallelism over the ranks (the store replicated on each), with
    ``spmd`` and ``zero_opt`` / ``min_rows`` as ``make_mapper``'s;
    ``queries_factory``: the map backend (``_build_core``).

    Returns map_frame(ms, store, est (n, 4, 4), color_u8 (H, W, 3),
    depth_u16 (H, W), inv_q, gt_c2w (4, 4), idx, draws, *, iters,
    lr_factor, joint_opt, admit, vis_hook=None, vis_every=1) -> losses
    (iters,) on the device.  ``ms``, ``store`` and ``est`` are updated in
    place; the packed store takes the packet's bytes as they are.
    ``vis_hook``: the in-loop panels (``_optimize_window``).  Draws: the
    selector's, then each iteration's (``loss_fn``).  The iterations are
    replayed from one captured graph where ``replayable`` says so (the
    module's docstring).
    """
    loss_fn, make_optimizer = _build_core(cfg, scene, cam, importance,
                                          packed, sharded, queries_factory,
                                          spmd)
    graph = None if sharded else MapGraph(loss_fn, make_optimizer)
    own_queries = queries_factory is None

    def map_frame(ms: MapState, store: KeyframeStore, est, color_u8,
                  depth_u16, inv_q: float, gt_c2w, idx: int, draws, *,
                  iters: int, lr_factor: float, joint_opt: bool,
                  admit: bool, vis_hook=None, vis_every: int = 1):
        count = store.count
        with torch.no_grad(), trace.span("map.select"):
            store.write_packet(scratch_slot, color_u8, depth_u16, inv_q)
            imagery = store.imagery()
            if packed:
                cur_depth = (store.depths_u16[scratch_slot].to(
                    torch.float32) * store.depth_inv_q[scratch_slot])
            else:
                cur_depth = store.depths[scratch_slot]
            cur_c2w = est[idx]
            slot_kf, n_slots, pose_mask = selector(
                store.est_c2w, count, cur_c2w, cur_depth, draws, joint_opt)
            c2ws = store.est_c2w[slot_kf]
            is_cur = torch.arange(w_max, device=est.device) == n_slots - 1
            c2ws = torch.where(is_cur[:, None, None], cur_c2w[None], c2ws)
        replay = replayable(est, sharded, own_queries, vis_hook)
        losses = _optimize_window(
            loss_fn, make_optimizer, ms, store, est, c2ws, pose_mask,
            slot_kf, slot_kf, n_slots, imagery, idx, draws, iters,
            lr_factor, joint_opt, vis_hook, vis_every, sharded, zero_opt,
            min_rows, graph, replay)
        with torch.no_grad():
            # Admission: the scratch slot's imagery and poses go to slot
            # ``count``; without admission the poses stay in the scratch.
            dst = count if admit else scratch_slot
            if admit:
                for buf in imagery:
                    if buf is not None:
                        buf[dst] = buf[scratch_slot]
            store.est_c2w[dst] = est[idx]
            store.gt_c2w[dst] = gt_c2w
        return losses

    return map_frame


def make_window_frame_mapper(cfg: dict, scene: SceneGeometry, cam: Camera,
                             w_max: int, importance: bool = True,
                             sharded: bool = False, zero_opt: bool = False,
                             min_rows: int = ZERO_MIN_ROWS):
    """One mapped frame over the host-staged store, whose window the
    caller selected and staged into the store's line cache
    (``KeyframeStore.stage_lines``): the iterations read the cache slab
    through ``win_lines`` with the packed store's gather, the poses go
    back to their global slots, and admission here is pose-only (the
    imagery is admitted on the host).  ``sharded``: ray data parallelism
    with the ``spmd`` draws whatever ``dp_impl`` says (the JAX package
    hands this mapper its ray sharding in both), every rank holding the
    whole host store and cache and staging the same lines; ``zero_opt``
    / ``min_rows``: the row-sharded Adam (``dp_impl: spmd``).

    Returns window_map(ms, store, est, slot_kf (w_max,), n_slots,
    pose_mask (w_max,), win_lines (w_max,), gt_c2w, idx, draws, *, iters,
    lr_factor, joint_opt, admit, vis_hook=None, vis_every=1) -> losses
    (iters,) on the device.  Draws: each iteration's (``loss_fn``).
    """
    loss_fn, make_optimizer = _build_core(cfg, scene, cam, importance,
                                          packed=True, sharded=sharded,
                                          spmd=True)

    def window_map(ms: MapState, store: KeyframeStore, est, slot_kf,
                   n_slots, pose_mask, win_lines, gt_c2w, idx: int, draws,
                   *, iters: int, lr_factor: float, joint_opt: bool,
                   admit: bool, vis_hook=None, vis_every: int = 1):
        with torch.no_grad():
            c2ws = store.est_c2w[slot_kf]
            is_cur = torch.arange(w_max, device=est.device) == n_slots - 1
            c2ws = torch.where(is_cur[:, None, None], est[idx][None], c2ws)
        losses = _optimize_window(
            loss_fn, make_optimizer, ms, store, est, c2ws, pose_mask,
            slot_kf, win_lines, n_slots,
            (store.cache_colors, store.cache_depths, store.cache_inv_q),
            idx, draws, iters, lr_factor, joint_opt, vis_hook, vis_every,
            sharded, zero_opt, min_rows)
        if admit:
            with torch.no_grad():
                store.est_c2w[store.count] = est[idx]
                store.gt_c2w[store.count] = gt_c2w
        return losses

    return window_map
