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

Spans (``utils/trace.py``): ``map.select`` (the scratch write and the
window's pick), per iteration ``map.iter`` holding ``map.loss``,
``map.backward`` and ``map.step``, and ``map.writeback`` (the window's
poses back to the store).
"""

from __future__ import annotations

import torch

from myslam_torch.core.geometry import ray_aabb_exit_t, rays_from_uv
from myslam_torch.core.losses import color_loss, depth_loss, \
    global_weighted_loss, sdf_losses, slam_terms
from myslam_torch.core.quaternion import cam_pose_to_matrix, \
    matrix_to_cam_pose
from myslam_torch.core.sampling import RowShardDraws, rank_rows
from myslam_torch.engine.camera import Camera
from myslam_torch.engine.keyframes import KeyframeStore
from myslam_torch.models.planes import MapState
from myslam_torch.ops.pixel_gather import gather_rgb, gather_scalar, \
    gather_u16
from myslam_torch.parallel import distributed
from myslam_torch.render.renderer import SceneGeometry, make_queries, \
    render_core
from myslam_torch.utils import trace


# Atlases of at least this many rows have their Adam moments row-sharded
# under ``zero_opt`` (the JAX package's ``make_row_sharder`` default).
ZERO_MIN_ROWS = 4096
# Bytes of Adam's moments of the atlases on this rank in the last mapped
# frame, and what a replicated Adam holds (chip_smoke.py reads them).
ADAM_BYTES = {"atlas_moments": 0, "atlas_moments_replicated": 0}


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
            with torch.no_grad():
                cur = torch.as_tensor(n_slots, device=poses.device)
                pose = poses.detach().index_select(0, cur.reshape(1) - 1)
                vis_hook(it, ms, cam_pose_to_matrix(pose)[0])
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
    if zero is not None:
        own, full = zero.moment_bytes()
        ADAM_BYTES.update(atlas_moments=own, atlas_moments_replicated=full)
    return torch.stack(losses) if losses else torch.zeros(
        (0,), device=poses.device)


def _optimize_window(loss_fn, make_optimizer, ms: MapState, store, est,
                     c2ws, pose_mask, slot_kf, lines, n_slots, imagery,
                     idx: int, draws, iters: int, lr_factor: float,
                     joint_opt: bool, vis_hook=None, vis_every: int = 1,
                     sharded: bool = False, zero_opt: bool = False,
                     min_rows: int = ZERO_MIN_ROWS):
    """The iterations over one window, then the masked pose write-back.

    ``c2ws`` (w_max, 4, 4) are the window's starting poses, ``slot_kf``
    its global store slots (where the poses go back), ``lines`` the
    imagery rows the rays read (``imagery``: colors, depths, inv_q).
    ``sharded``, ``zero_opt`` and ``min_rows`` as _iterate's.
    ``vis_hook(m, ms, c2w)``, when given, is called before iteration m's
    step for every multiple m of ``vis_every`` with 0 < m < iters, with
    the map after m iterations and the current frame's pose (slot
    n_slots - 1); without it the loop reads nothing back.
    Returns the losses (iters,) on the device."""
    poses = matrix_to_cam_pose(c2ws).requires_grad_()
    losses = _iterate(loss_fn, make_optimizer, ms, poses, pose_mask, lines,
                      n_slots, imagery, draws, iters, lr_factor, sharded,
                      vis_hook, vis_every, zero_opt, min_rows)
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
    selector's, then each iteration's (``loss_fn``).
    """
    loss_fn, make_optimizer = _build_core(cfg, scene, cam, importance,
                                          packed, sharded, queries_factory,
                                          spmd)

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
        losses = _optimize_window(
            loss_fn, make_optimizer, ms, store, est, c2ws, pose_mask,
            slot_kf, slot_kf, n_slots, imagery, idx, draws, iters,
            lr_factor, joint_opt, vis_hook, vis_every, sharded, zero_opt,
            min_rows)
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
