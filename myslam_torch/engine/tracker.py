"""Per-frame camera tracking: Adam on a 7-dof pose against a frozen map.

Reference semantics, as in ``myslam_tpu.engine.tracker``:
  * a fresh Adam per frame, betas (0.5, 0.999), separate groups (and
    learning rates) for the quaternion R and the translation T;
  * the loss of each iteration is taken at the pre-update pose, and the
    pose with the lowest such loss wins;
  * rays leaving the bound before their depth, depth-less rays, and
    rays whose depth error exceeds 10x the median are masked out;
  * fresh pixels every iteration (drawn on the host, ``build_packet``).

The loop is eager Python; nothing in it waits for the device.

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

import torch

from myslam_torch.core.geometry import ray_aabb_exit_t, rays_from_uv
from myslam_torch.core.losses import color_loss, depth_loss, \
    global_weighted_loss, masked_median, sdf_losses, slam_terms
from myslam_torch.core.quaternion import cam_pose_to_matrix, \
    matrix_to_cam_pose
from myslam_torch.core.sampling import RowShardDraws
from myslam_torch.engine.camera import Camera
from myslam_torch.models.planes import MapState
from myslam_torch.ops.plane_sample import pack_quad
from myslam_torch.parallel import distributed
from myslam_torch.render.renderer import SceneGeometry, render_rays


def _rank_rows(x: torch.Tensor, rows: int, rank: int) -> torch.Tensor:
    """Rows [rank * rows, (rank + 1) * rows) of x, zero-padded past its
    end."""
    part = x[rank * rows:(rank + 1) * rows]
    if part.shape[0] < rows:
        part = torch.cat([part, part.new_zeros(
            (rows - part.shape[0],) + tuple(x.shape[1:]))])
    return part


def make_track_core(cfg: dict, scene: SceneGeometry, cam: Camera,
                    sharded: bool = False):
    """The per-frame optimization (``sharded``: over the process group's
    ranks, see the module's docstring).

    Returns core(ms, quads, pose_init (7,), px_i (iters, n),
    px_j (iters, n), px_color (iters, n, 3) uint8, px_depth (iters, n),
    draws) -> (best_pose (7,), losses (iters,), iter_poses (iters, 7)),
    all on the device.  ``quads`` are the frozen (sdf, color) quad
    atlases (``pack_tracking_quads``).
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
            i, j, px_color, px_depth = (_rank_rows(x, rows, rank) for x in
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

    def core(ms: MapState, quads, pose_init, px_i, px_j, px_color, px_depth,
             draws):
        R = pose_init[:4].detach().clone().requires_grad_()
        T = pose_init[4:].detach().clone().requires_grad_()
        opt = torch.optim.Adam([{"params": [R], "lr": lr_R},
                                {"params": [T], "lr": lr_T}],
                               betas=(0.5, 0.999))
        best_loss = torch.full((), float("inf"), device=pose_init.device)
        best_pose = pose_init.detach()
        losses, poses = [], []
        for it in range(iters):
            loss = loss_fn(R, T, ms, quads, px_i[it], px_j[it], px_color[it],
                           px_depth[it], draws)
            R.grad, T.grad = torch.autograd.grad(loss, [R, T])
            if sharded:
                g = distributed.all_reduce_(torch.cat([R.grad, T.grad]),
                                            "track_grad")
                R.grad, T.grad = g[:4], g[4:]
            pose = torch.cat([R, T]).detach()
            loss = loss.detach()
            best_pose = torch.where(loss < best_loss, pose, best_pose)
            best_loss = torch.minimum(loss, best_loss)
            losses.append(loss)
            poses.append(pose)
            opt.step()
        return best_pose, torch.stack(losses), torch.stack(poses)

    return core


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
