"""Keyframe-sharded bundle adjustment over the ranks of a process group.

The port of ``myslam_tpu/parallel/distributed_ba.py``, its ``kf`` axis
and its composition with ray DP (``dp``: a K x D grid of ranks, rank r
the kf row r // D and the dp column r % D):

  * **Keyframe partitioning.**  The keyframe imagery is sharded by slot
    (``KeyframeStore(shard=...)``): rank r holds slots
    ``[r * cap_l, (r + 1) * cap_l)``.  Each rank draws its share of the
    ray budget (``pixels / R``) from the window slots it owns, so raw
    pixels never cross ranks.  Its pixel draws are its row of a
    ``(R, rays)`` draw that every rank makes from the shared draw source:
    the JAX package folds the shard index into the key, the port folds
    the rank into the stream the same way, and the stream stays one.
  * **kf x dp.**  The imagery is sharded over the kf rows and replicated
    along them; a row's ray budget splits over its dp columns
    (``pixels / (K D)`` rays each, distinct draws: the JAX package folds
    the dp index in after the kf index, the port takes row ``r`` of a
    ``(K D, rays)`` draw), and every loss, gradient and Schur sum
    reduces over all K D ranks.
  * **Map and decoder gradients.**  The map is replicated; the masked
    means are global (their sums and counts cross the ranks in one
    all-reduce), and the gradients are summed as one flat buffer in one
    all-reduce per iteration before Adam.
  * **Schur-style pose step** (``pose_solver: schur``).  Each iteration
    first solves the reduced pose system: per ray a 4-vector residual
    (depth and color, weighted by the square roots of their loss
    weights) and its 4x7 Jacobian against the ray's own copy of its
    window pose, by one forward and four backward passes through the
    sample with the map detached (K2 then computes the coordinate
    gradient alone); H (W, 7, 7) = sum J^T J and g (W, 7) = sum J^T r by
    ``index_add_``, summed over the ranks in one all-reduce (W x 56
    floats) and solved with Levenberg damping on every rank.  The map
    step then runs at the solved poses with their gradient stopped.  The
    bare step's ``schur_interval`` k > 1 solves only on iterations whose
    index is a multiple of k (the poses move slowly against the map;
    ``tools/bench_pose_solver.py``); the others take the map step at the
    poses as they are.

``pose_solver: adam`` optimizes the poses jointly with the map by Adam,
as the single-device mapper does.
"""

from __future__ import annotations

import numpy as np
import torch

from myslam_torch.core.geometry import normalize_3d_coordinate, \
    ray_aabb_exit_t, rays_from_uv
from myslam_torch.core.losses import global_weighted_loss, slam_terms
from myslam_torch.core.quaternion import cam_pose_to_matrix, \
    matrix_to_cam_pose
from myslam_torch.core.sampling import RecordedDraws, depth_guided_z_vals
from myslam_torch.engine.camera import Camera
from myslam_torch.engine.keyframes import KeyframeStore
from myslam_torch.engine.mapper import make_map_optimizer, map_quad_dtype, \
    optimizer_params
from myslam_torch.models.planes import MapState
from myslam_torch.ops import cuda_sample
from myslam_torch.ops.composite import composite, sdf2alpha
from myslam_torch.ops.pixel_gather import gather_rgb, gather_scalar, \
    gather_u16
from myslam_torch.parallel import distributed
from myslam_torch.render.renderer import SceneGeometry, build_z_vals_core, \
    make_queries, render_core, shade

# K2 launches made inside the reduced pose system (its pullbacks, on
# frozen quads), read by chip_smoke.py; the wrapper's own count is
# cuda_sample.LAUNCHES.
SCHUR_LAUNCHES = {"plane_sample_fwd": 0, "plane_sample_bwd": 0}

# Levenberg damping of the reduced pose solve, relative to the mean
# diagonal of each pose's block (the JAX package's default).
LM_DAMPING = 0.1


def _loss_weights(cfg: dict) -> tuple:
    m = cfg["mapping"]
    return (float(m["w_sdf_fs"]), float(m["w_sdf_center"]),
            float(m["w_sdf_tail"]), float(m["w_color"]), float(m["w_depth"]))


def make_local_ray_picker(cam: Camera, n_rays: int, packed: bool = False,
                          dp: int = 1):
    """This rank's ray draw from the window slots its kf row owns (``dp``
    columns per kf row; 1: every rank is a kf row).

    Returns pick(slot_kf (W,), n_slots, imagery, local_capacity, draws)
      -> (p (R,) window positions, i, j, px_depth, px_color, valid)
    with R = ``n_rays`` this rank's budget.  ``imagery`` is the rank's
    store buffers (``KeyframeStore.imagery()``); global slot s lives on
    rank s // local_capacity.  The owned window positions are cycled
    over the rays; a rank that owns none keeps its rays but marks them
    invalid (``valid`` False), so it still takes part in every
    collective.  Draws: ``randint((R_world, n_rays))`` for the pixel
    columns, then for the rows; this rank takes its row of each.
    """
    HW = cam.H * cam.W

    def pick(slot_kf, n_slots, imagery, local_capacity: int, draws):
        r, world = distributed.rank(), distributed.world()
        me = r // dp
        dev = slot_kf.device
        W = slot_kf.shape[0]
        pos = torch.arange(W, device=dev)
        owned = ((slot_kf // local_capacity) == me) & (pos < n_slots)
        k_own = owned.sum()
        # Owned positions ascending, then zeros (JAX's nonzero(size=W)).
        order = torch.sort((~owned).to(torch.int8), stable=True).indices
        owned_pos = torch.where(pos < k_own, order, torch.zeros_like(order))
        p = owned_pos[torch.arange(n_rays, device=dev)
                      % torch.clamp(k_own, min=1)]
        valid = k_own > 0
        local_slot = (slot_kf % local_capacity)[p]
        i = draws.randint((world, n_rays), 0, cam.W)[r].to(torch.float32)
        j = draws.randint((world, n_rays), 0, cam.H)[r].to(torch.float32)
        flat = local_slot * HW + j.long() * cam.W + i.long()
        colors, depths, inv_q = imagery
        if packed:
            px_depth = (gather_u16(depths, flat).to(torch.float32)
                        * inv_q[local_slot])
            px_color = (gather_rgb(colors, flat).to(torch.float32)
                        * (1.0 / 255.0))
        else:
            px_depth = gather_scalar(depths, flat)
            px_color = gather_rgb(colors, flat).to(torch.float32)
        return p, i, j, px_depth, px_color, valid

    return pick


def _global_loss(cfg, scene, sdf, z_vals, depth, color, px_depth, px_color,
                 inside):
    dmask = inside & (px_depth > 0)
    return global_weighted_loss(
        slam_terms(sdf, z_vals, px_depth, dmask, scene.truncation, px_color,
                   color, inside, depth, dmask), _loss_weights(cfg),
        lambda t: distributed.all_reduce_(t, "loss"))


def _solve(H, g, poses, pose_mask):
    """The Levenberg-damped Gauss-Newton step of every window pose."""
    damp = LM_DAMPING * torch.clamp(
        torch.diagonal(H, dim1=1, dim2=2).sum(-1)[:, None] / 7.0, min=1e-6)
    eye = torch.eye(7, device=H.device, dtype=H.dtype)
    delta = -torch.linalg.solve(H + damp[..., None] * eye, g[..., None])[
        ..., 0]
    return poses + delta * pose_mask[:, None]


def make_pose_system(cfg: dict, scene: SceneGeometry, cam: Camera,
                     exact_color: bool = True):
    """The reduced pose normal equations, summed over the ranks.

    Returns pose_system(ms, poses (W, 7), p (R,), i, j, px_depth,
    px_color, z_vals (R, N), valid) -> (H (W, 7, 7), g (W, 7)).  The
    residual of ray r at its window pose poses[p[r]]: depth and color
    against the input, masked as the loss masks them (rays leaving the
    bound before their depth, depth-less rays for the depth row), scaled
    by the square roots of the loss weights.  ``exact_color``: the color
    composited over every sample (the frame mapper's choice, smooth in
    the pose); else the renderer's top-K color (the bare BA step's).
    The map is detached and the quads packed without a gradient, so K2
    runs coordinate-only: one forward, four pullbacks per ray batch.
    """
    m = cfg["mapping"]
    sqrt_wd = float(np.sqrt(float(m["w_depth"])))
    sqrt_wc = float(np.sqrt(float(m["w_color"])))
    quad_dtype = map_quad_dtype(cfg)

    def pose_system(ms: MapState, poses, p, i, j, px_depth, px_color,
                    z_vals, valid):
        with torch.no_grad():
            q = make_queries(ms, scene, quad_dtype=quad_dtype)
        before = dict(cuda_sample.LAUNCHES)
        bound = scene.bound_tensor(poses.device)
        pose_of_ray = poses.detach()[p].clone().requires_grad_()
        c2w = cam_pose_to_matrix(pose_of_ray)
        ro, rd = rays_from_uv(i, j, c2w, cam.fx, cam.fy, cam.cx, cam.cy)
        pts = ro[:, None, :] + rd[:, None, :] * z_vals[..., None]
        p_nor = normalize_3d_coordinate(pts.reshape(-1, 3), bound)
        sdf = q.sdf(p_nor).reshape(z_vals.shape)
        if exact_color:
            rgb = q.rgb(p_nor).reshape(z_vals.shape + (3,))
            depth, color, _ = composite(sdf2alpha(sdf, q.beta), z_vals, rgb)
        else:
            depth, color = shade(scene, q, sdf, z_vals, pts, p_nor)
        with torch.no_grad():
            ins = (ray_aabb_exit_t(ro, rd, bound) >= px_depth) & valid
            md = (ins & (px_depth > 0)).to(torch.float32)
            mc = ins.to(torch.float32)
        r = torch.cat([(sqrt_wd * (depth - px_depth) * md)[:, None],
                       sqrt_wc * (color - px_color) * mc[:, None]], dim=1)
        # Each ray's residual depends on its own pose row alone, so the
        # gradient of a residual row's sum is that row of every J.
        J = torch.stack([torch.autograd.grad(r[:, k].sum(), pose_of_ray,
                                             retain_graph=k < 3)[0]
                         for k in range(4)], dim=1)  # (R, 4, 7)
        for name in SCHUR_LAUNCHES:
            SCHUR_LAUNCHES[name] += cuda_sample.LAUNCHES[name] - before[name]
        r = r.detach()
        W = poses.shape[0]
        H = torch.zeros((W, 7, 7), device=poses.device).index_add_(
            0, p, torch.einsum("rij,rik->rjk", J, J))
        g = torch.zeros((W, 7), device=poses.device).index_add_(
            0, p, torch.einsum("rij,ri->rj", J, r))
        both = distributed.all_reduce_(
            torch.cat([H.reshape(-1), g.reshape(-1)]), "schur")
        return both[:W * 49].reshape(W, 7, 7), both[W * 49:].reshape(W, 7)

    return pose_system


def make_distributed_ba(cfg: dict, scene: SceneGeometry, cam: Camera,
                        iters: int | None = None, pose_solver: str = "schur",
                        packed: bool = False, schur_interval: int = 1):
    """The bare keyframe-sharded BA step (the port of
    ``make_distributed_ba``).

    Returns ba_step(ms, poses (W, 7), pose_mask (W,), slot_kf (W,),
    n_slots, imagery, local_capacity, draws) -> (poses (W, 7), losses
    (iters,)); ``ms`` is updated in place.  Adam at the mapping rates
    times ``mapping.lr_factor`` on the map; the poses by Adam at
    ``joint_opt_cam_lr`` or, with ``pose_solver="schur"``, by the damped
    reduced solve first (on every ``schur_interval``-th iteration of the
    call, from its first), and the map step at the solved poses.  Draws
    per iteration: the picker's, then the depth-guided jitter
    (``uniform((rays, N))`` when perturb).
    """
    if pose_solver not in ("adam", "schur"):
        raise ValueError(f"unknown pose_solver {pose_solver!r}")
    m = cfg["mapping"]
    n_iters = int(iters if iters is not None else m["iters"])
    n_rays = max(int(m["pixels"]) // distributed.world(), 1)
    lr_factor = float(m["lr_factor"])
    quad_dtype = map_quad_dtype(cfg)
    pick = make_local_ray_picker(cam, n_rays, packed)
    pose_system = make_pose_system(cfg, scene, cam, exact_color=False)

    def map_loss(ms, poses, pose_mask, p, i, j, px_depth, px_color, z_vals,
                 valid):
        bound = scene.bound_tensor(poses.device)
        poses = torch.where(pose_mask[:, None] > 0, poses, poses.detach())
        c2ws = cam_pose_to_matrix(poses)
        rays_o, rays_d = rays_from_uv(i, j, c2ws[p], cam.fx, cam.fy, cam.cx,
                                      cam.cy)
        q = make_queries(ms, scene, quad_dtype=quad_dtype)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        p_nor = normalize_3d_coordinate(pts.reshape(-1, 3), bound)
        sdf = q.sdf(p_nor).reshape(z_vals.shape)
        depth, color = shade(scene, q, sdf, z_vals, pts, p_nor)
        t_exit = ray_aabb_exit_t(rays_o.detach(), rays_d.detach(), bound)
        inside = (t_exit >= px_depth) & valid
        return _global_loss(cfg, scene, sdf, z_vals, depth, color, px_depth,
                            px_color, inside)

    def ba_step(ms: MapState, poses, pose_mask, slot_kf, n_slots, imagery,
                local_capacity: int, draws):
        poses = poses.detach().clone().requires_grad_(pose_solver == "adam")
        map_opt = make_map_optimizer(cfg, ms, None, lr_factor)
        map_params = optimizer_params(map_opt)
        pose_opt = (torch.optim.Adam([poses],
                                     lr=float(m["joint_opt_cam_lr"]))
                    if pose_solver == "adam" else None)
        losses = []
        for it in range(n_iters):
            p, i, j, px_depth, px_color, valid = pick(
                slot_kf, n_slots, imagery, local_capacity, draws)
            z_vals = depth_guided_z_vals(
                draws, px_depth, scene.truncation, scene.n_stratified,
                scene.n_importance, scene.perturb)
            map_opt.zero_grad(set_to_none=True)
            if pose_solver == "schur":
                if it % schur_interval == 0:
                    H, g = pose_system(ms, poses, p, i, j, px_depth,
                                       px_color, z_vals, valid)
                    with torch.no_grad():
                        poses = _solve(H, g, poses, pose_mask)
                loss = map_loss(ms, poses.detach(), pose_mask, p, i, j,
                                px_depth, px_color, z_vals, valid)
                loss.backward()
                distributed.all_reduce_grads(map_params)
            else:
                pose_opt.zero_grad(set_to_none=True)
                loss = map_loss(ms, poses, pose_mask, p, i, j, px_depth,
                                px_color, z_vals, valid)
                loss.backward()
                distributed.all_reduce_grads(map_params + [poses])
                pose_opt.step()
            map_opt.step()
            losses.append(loss.detach())
        return poses.detach(), torch.stack(losses)

    return ba_step


def make_kf_frame_mapper(cfg: dict, scene: SceneGeometry, cam: Camera,
                         selector, w_max: int, scratch_slot: int,
                         importance: bool = True, pose_solver: str = "adam",
                         packed: bool = False, dp: int = 1):
    """One mapped frame with keyframe-sharded BA (the port of
    ``make_kf_frame_mapper`` on a ``kf`` mesh, or with ``dp`` > 1 on a
    ``(kf, dp)`` mesh of the ranks), the same contract as
    ``engine/mapper.make_frame_mapper`` over a store sharded over the kf
    rows (``KeyframeStore(shard=(rank // dp, K))``):

      * the current frame's imagery goes to the scratch slot's owner, and
        every rank selects the same window from the whole poses and the
        packet's depth;
      * the iterations: each rank's rays from its own window slots
        (``make_local_ray_picker``), global masked means, one gradient
        all-reduce; the poses by Adam or by the reduced solve first
        (``pose_solver``), whose residual composites color over every
        sample (the top-K choice makes the pose gradient jump);
      * the masked pose write-back, and admission: the slot's owner
        writes the packet's imagery at ``count`` (the scratch slot
        without admission), every rank the poses.

    Returns map_frame(ms, store, est, color_u8, depth_u16, inv_q, gt_c2w,
    idx, draws, *, iters, lr_factor, joint_opt, admit) -> losses (iters,).
    Draws: the selector's, then per iteration the picker's and the
    renderer's (the Schur system builds its samples from the draws that
    the loss then uses again).
    """
    if pose_solver not in ("adam", "schur"):
        raise ValueError(f"unknown pose_solver {pose_solver!r}")
    m = cfg["mapping"]
    n_rays = max(int(m["pixels"]) // distributed.world(), 1)
    quad_dtype = map_quad_dtype(cfg)
    pick = make_local_ray_picker(cam, n_rays, packed, dp)
    pose_system = make_pose_system(cfg, scene, cam, exact_color=True)
    schur = pose_solver == "schur"

    def rays_at(poses, p, i, j):
        c2ws = cam_pose_to_matrix(poses)
        return rays_from_uv(i, j, c2ws[p], cam.fx, cam.fy, cam.cx, cam.cy)

    def loss_fn(ms, poses, pose_mask, p, i, j, px_depth, px_color, valid,
                draws):
        bound = scene.bound_tensor(poses.device)
        if schur:
            poses = poses.detach()
        else:
            poses = torch.where(pose_mask[:, None] > 0, poses,
                                poses.detach())
        rays_o, rays_d = rays_at(poses, p, i, j)
        t_exit = ray_aabb_exit_t(rays_o.detach(), rays_d.detach(), bound)
        inside = (t_exit >= px_depth) & valid
        q = make_queries(ms, scene, quad_dtype=quad_dtype)
        depth, color, sdf, z_vals = render_core(
            draws, scene, rays_o, rays_d, px_depth, importance, q)
        return _global_loss(cfg, scene, sdf, z_vals, depth, color, px_depth,
                            px_color, inside)

    def map_frame(ms: MapState, store: KeyframeStore, est, color_u8,
                  depth_u16, inv_q: float, gt_c2w, idx: int, draws, *,
                  iters: int, lr_factor: float, joint_opt: bool,
                  admit: bool, vis_hook=None, vis_every: int = 1):
        if vis_hook is not None:
            raise ValueError("keyframe-sharded mapping draws no panels")
        count = store.count
        dev = est.device
        with torch.no_grad():
            store.write_packet(scratch_slot, color_u8, depth_u16, inv_q)
            cur_depth = depth_u16.to(torch.float32) * inv_q
            cur_c2w = est[idx]
            slot_kf, n_slots, pose_mask = selector(
                store.est_c2w, count, cur_c2w, cur_depth, draws, joint_opt)
            c2ws = store.est_c2w[slot_kf]
            is_cur = torch.arange(w_max, device=dev) == n_slots - 1
            c2ws = torch.where(is_cur[:, None, None], cur_c2w[None], c2ws)
        poses = matrix_to_cam_pose(c2ws).requires_grad_(not schur)
        opt = make_map_optimizer(cfg, ms, None if schur else poses,
                                 lr_factor)
        params = optimizer_params(opt)
        imagery = store.imagery()
        losses = []
        for _ in range(iters):
            p, i, j, px_depth, px_color, valid = pick(
                slot_kf, n_slots, imagery, store.local_capacity, draws)
            loss_draws = draws
            if schur:
                rec = RecordedDraws(draws)
                with torch.no_grad():
                    rays_o, rays_d = rays_at(poses, p, i, j)
                    z_vals = build_z_vals_core(
                        rec, scene, rays_o, rays_d, px_depth, importance,
                        make_queries(ms, scene, quad_dtype=quad_dtype))
                H, g = pose_system(ms, poses, p, i, j, px_depth, px_color,
                                   z_vals, valid)
                with torch.no_grad():
                    poses = _solve(H, g, poses, pose_mask)
                loss_draws = rec.replay()
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(ms, poses, pose_mask, p, i, j, px_depth,
                           px_color, valid, loss_draws)
            loss.backward()
            distributed.all_reduce_grads(params)
            opt.step()
            losses.append(loss.detach())
        with torch.no_grad():
            c2ws_out = cam_pose_to_matrix(poses.detach())
            old = store.est_c2w[slot_kf]
            store.est_c2w[slot_kf] = torch.where(
                pose_mask[:, None, None] > 0, c2ws_out, old)
            if joint_opt:
                est[idx] = c2ws_out[n_slots - 1]
            dst = count if admit else scratch_slot
            store.write_packet(dst, color_u8, depth_u16, inv_q)
            store.est_c2w[dst] = est[idx]
            store.gt_c2w[dst] = gt_c2w
        return torch.stack(losses) if losses else torch.zeros((0,),
                                                               device=dev)

    return map_frame
