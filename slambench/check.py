"""The comparison that decides ``correct``.

The SLAM loop runs thousands of optimisation steps whose rounding (the
atomics of the sample's backward) makes two runs part ways, so no
reference can follow a whole run.  The check follows the program step by
step instead, from the program's own state, on the one mapped group the
seed picks among the window's first ``check_groups``:

  * tracking: from each frame's start pose and then from the pose before
    each iteration, the reference's loss and the pose after its own Adam
    step (its own moments) against the program's;
  * mapping: from the map and the window's poses before each iteration
    (the first iteration's poses the reference's own, from the store's
    matrices), the reference's loss and the map and poses after its step
    (the decoders, both planes' atlases, the window's poses) against the
    program's, the first iteration's apart; and the poses written back to
    the store after the last step (as matrices) against the reference's;
  * the start, by itself: the initial map against the reference's draw
    from the seed (exact);
  * the keyframe store's imagery of a sample of slots against the
    reference's encoding of the frames the slots should hold (exact);
  * the mapping window: the keyframes whose poses the program's step
    moved against the reference's own pick (exact).

The reference takes the frames from the benchmark's frame source and the
program's random choices (tracking pixels, uniforms) as recorded; it
works out the rays, the window, the imagery, the field and the updates
itself.  A gap is ``|program - reference|`` over the reference's norm of
the step, or of the median leaf's step where that is larger.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference.field import Field, matrix_to_pose, \
    pose_to_matrix
from slambench.reference.steps import Adam, Draws, encode, init_map, \
    map_loss, select_window, track_loss

DEC_MLP = [f"{f}.{k}.{p}" for f in ("sdf", "rgb") for k in (0, 1)
           for p in ("weight", "bias")] + [
    f"{f}_out.{p}" for f in ("sdf", "rgb") for p in ("weight", "bias")]


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: dict, ref: dict, start: dict, grads: dict) -> float:
    """The worst leaf's ``|dprog - dref| / max(|dref|, median |dref|)``
    of one step from ``start``.  Leaves whose reference gradient is under
    a thousandth of the median leaf's, and within a leaf the elements
    whose gradient is under a thousandth of the leaf's root mean square,
    are left out: Adam's update divides each element by its own gradient's
    size, so it moves them by rounding alone (the sum of the sample's
    backward, by atomics, fixes their sign)."""
    g = {n: float(grads[n].norm()) for n in ref}
    g_med = float(np.median(list(g.values())))
    live = [n for n in ref if g[n] >= 1e-3 * g_med]
    keep, steps = {}, {}
    for n in live:
        gn = grads[n].abs()
        rms = float(gn.square().mean().sqrt())
        keep[n] = gn >= 1e-3 * rms
        steps[n] = float(((ref[n] - start[n]) * keep[n]).norm())
    med = float(np.median(list(steps.values()))) if steps else 0.0
    worst = 0.0
    for n in live:
        d = float((((prog[n] - start[n]) - (ref[n] - start[n]))
                   * keep[n]).norm())
        worst = max(worst, d / max(steps[n], med, 1e-30))
    return worst


class Frames:
    """The benchmark's frames as the reference needs them, rendered once
    each: the host arrays and their encoding."""

    def __init__(self, source):
        self.source = source
        self.cache: dict = {}

    def get(self, idx: int):
        if idx not in self.cache:
            color, depth, _ = self.source.frame_host(idx)
            self.cache[idx] = (color, depth, *encode(color, depth))
        return self.cache[idx]

    def store_imagery(self, idx: int, packed: bool, device):
        """The imagery a keyframe slot holding frame ``idx`` should have:
        (colour (H, W, 3) f32 in [0, 1] as the mapper reads it, depth
        (H, W) f32, and the stored tensors)."""
        _, _, c8, d16, inv_q = self.get(idx)
        c = torch.as_tensor(c8, device=device)
        d = torch.as_tensor(d16.astype(np.int32), device=device)
        depth = d.to(torch.float32) * torch.tensor(inv_q, dtype=torch.float32,
                                                   device=device)
        if packed:
            color = c.to(torch.float32) * (1.0 / 255.0)
            stored = (c, d, torch.tensor([inv_q], dtype=torch.float32,
                                         device=device))
        else:
            color = (c.to(torch.float32) * (1.0 / 255.0)).to(torch.float16)
            stored = (color, depth)
            color = color.to(torch.float32)
        return color, depth, stored


def admitted_frames(cfg: dict, n_img: int, upto: int) -> list:
    """Frames admitted to the store before frame ``upto``, in slot
    order: the mapped frames (every ``every_frame``-th and the last) that
    are keyframes (every ``keyframe_every``-th)."""
    m = cfg["mapping"]
    ef, ke = int(m["every_frame"]), int(m["keyframe_every"])
    mapped = sorted(set(range(0, n_img, ef)) | {n_img - 1})
    return [f for f in mapped if f < upto and f % ke == 0]


def check_init(cfg: dict, seed: int, init: dict) -> int:
    """Elements of the program's initial map that differ from the
    reference's draw from the seed."""
    planes, planes_c, dec = init_map(cfg, seed, init["planes"].shape[0],
                                     init["planes_c"].shape[0])
    bad = int((init["planes"] != planes).sum() + (init["planes_c"]
                                                  != planes_c).sum())
    for n, v in dec.items():
        bad += int((init["dec"][n].cpu() != v).sum())
    return bad


def check_store(cfg: dict, frames: Frames, n_img: int, upto: int,
                slots: dict, packed: bool, device) -> int:
    """Elements of the sampled store slots (``slots``: slot -> the
    program's stored tensors) that differ from the reference's encoding
    of the frame each slot should hold."""
    order = admitted_frames(cfg, n_img, upto)
    bad = 0
    for slot, got in slots.items():
        if slot >= len(order):
            return 1 + bad
        _, _, want = frames.store_imagery(order[slot], packed, device)
        for g, w in zip(got, want):
            g = g.to(device)
            if g.dtype == torch.uint16:
                g = g.to(torch.int32)
            bad += int((g.reshape(w.shape) != w).sum())
    return bad


def follow_tracking(cfg: dict, rec: dict, frames: Frames, dtype):
    """(loss gap, step gap) of the recorded tracking group."""
    t = cfg["tracking"]
    dev = rec["iter_poses"].device
    field = Field(cfg, rec["planes"], rec["planes_c"], rec["dec"], dtype)
    draws = Draws(rec["draws"])
    G, iters = rec["iter_poses"].shape[:2]
    loss_gap = step_gap = 0.0
    for g in range(G):
        color, depth, _, _, _ = frames.get(rec["idx0"] + g)
        adam = Adam([(float(t["lr_R"]), ["R"]), (float(t["lr_T"]), ["T"])],
                    betas=(0.5, 0.999))
        losses = []
        for k in range(iters):
            i = rec["px_i"][g, k].long()
            j = rec["px_j"][g, k].long()
            ih, jh = i.cpu().numpy(), j.cpu().numpy()
            px_c = torch.as_tensor(np.clip(np.rint(color[jh, ih] * 255.0), 0,
                                           255).astype(np.float32),
                                   device=dev) * (1.0 / 255.0)
            px_d = torch.as_tensor(depth[jh, ih], device=dev)
            pose = rec["iter_poses"][g, k]
            R = pose[:4].clone().requires_grad_()
            T = pose[4:].clone().requires_grad_()
            loss = track_loss(cfg, field, torch.cat([R, T]),
                              i.to(torch.float32), j.to(torch.float32),
                              px_c, px_d, draws)
            gR, gT = torch.autograd.grad(loss, [R, T])
            losses.append(float(loss.detach()))
            nxt = adam.step({"R": R.detach(), "T": T.detach()},
                            {"R": gR, "T": gT})
            if k + 1 < iters:
                prog = rec["iter_poses"][g, k + 1]
                step_gap = max(step_gap, leaf_gaps(
                    {"R": prog[:4], "T": prog[4:]}, nxt,
                    {"R": R.detach(), "T": T.detach()}, {"R": gR, "T": gT}))
        loss_gap = max(loss_gap,
                       rel(float(rec["loss_first"][g]), losses[0]),
                       rel(float(rec["loss_best"][g]), min(losses)))
    if draws.k != len(draws.draws):
        raise ValueError("the program drew more in tracking than the "
                         "reference used")
    return loss_gap, step_gap


def follow_mapping(cfg: dict, rec: dict, frames: Frames, n_img: int,
                   dtype):
    """The recorded mapped frame's gaps: every iteration's loss, the first
    iteration's step and the worst step of all (map and window poses),
    the poses written back after the last step, and the window's
    mismatch."""
    m = cfg["mapping"]
    dev = rec["cur_c2w"].device
    idx, packed = rec["idx"], rec["packed"]
    draws = Draws(rec["draws"])
    order = admitted_frames(cfg, n_img, idx)
    cur_color, cur_depth, _ = frames.store_imagery(idx, packed, dev)
    joint = rec["joint_opt"]
    slots, pose_mask = select_window(
        cfg, rec["est_c2w_before"], rec["count"], rec["cur_c2w"], cur_depth,
        draws, joint, rec["capacity"])
    imgs = [frames.store_imagery(order[s], packed, dev)[:2] if s >= 0
            else (cur_color, cur_depth) for s in slots]
    colors = torch.stack([c for c, _ in imgs])
    depths = torch.stack([d for _, d in imgs])
    kf_of_slot = torch.arange(len(slots), device=dev)
    c2w0 = torch.stack([rec["est_c2w_before"][s] if s >= 0
                        else rec["cur_c2w"] for s in slots])
    # The program's window poses before each step and after the last, its
    # rows in the window's order (the chosen slots ascending, then the
    # current frame, then padding).
    prog_poses = [p[:len(slots)] for p in rec["poses"]]
    lr = m["lr"]
    f = rec["lr_factor"]
    dec_names = DEC_MLP + (["beta"] if bool(
        cfg["rendering"].get("learnable_beta", True)) else [])
    adam = Adam([(float(lr["decoders_lr"]) * f, dec_names),
                 (float(lr["planes_lr"]) * f, ["planes"]),
                 (float(lr["c_planes_lr"]) * f, ["planes_c"]),
                 (float(m["joint_opt_cam_lr"]), ["poses"])])
    loss_gap = 0.0
    step_gaps = []
    states = rec["states"]
    nxt = None
    for k in range(rec["iters"]):
        s = states[k]
        leaves = {"planes": s["planes"].clone().requires_grad_(),
                  "planes_c": s["planes_c"].clone().requires_grad_()}
        dec = {n: v.clone().requires_grad_() for n, v in s["dec"].items()}
        # The first step from the reference's own poses of the store's
        # matrices, each later one from the program's poses.
        p = (matrix_to_pose(c2w0) if k == 0 else prog_poses[k]).detach(
            ).clone().requires_grad_()
        field = Field(cfg, leaves["planes"], leaves["planes_c"], dec, dtype)
        loss = map_loss(cfg, field, p, pose_mask, kf_of_slot, len(slots),
                        colors, depths, rec["importance"], draws)
        names = ["planes", "planes_c"] + dec_names
        params = {**leaves, **dec}
        grads = torch.autograd.grad(loss, [params[n] for n in names] + [p],
                                    allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(params[n]))
                 for n, g in zip(names + ["poses"], grads)}
        start = {n: params[n].detach() for n in names}
        start["poses"] = p.detach()
        nxt = adam.step(start, grads)
        after = states[k + 1]
        prog = {"planes": after["planes"], "planes_c": after["planes_c"],
                **{n: after["dec"][n] for n in dec_names},
                "poses": prog_poses[k + 1]}
        loss_gap = max(loss_gap, rel(float(rec["losses"][k]),
                                     float(loss.detach())))
        step_gaps.append(leaf_gaps(prog, nxt, start, grads))
    if draws.k != len(draws.draws):
        raise ValueError("the program drew more in mapping than the "
                         "reference used")
    # The poses written back after the last step, as matrices: the
    # program's store (and trajectory, for the current frame under joint
    # optimisation) against the reference's last step, each row's gap
    # over that step's movement (or the median row's, if larger).
    ref_c2w = pose_to_matrix(nxt["poses"])
    prev_c2w = pose_to_matrix(start["poses"])
    prog_c2w = torch.stack([rec["est_c2w_after"][s] if s >= 0 else (
        rec["cur_after"] if joint else rec["cur_c2w"]) for s in slots])
    # The program's window, as the keyframe slots whose poses its step
    # changed, against the reference's (joint optimisation only).
    window_mismatch = 0
    if joint:
        count = rec["count"]
        moved = (rec["est_c2w_after"][:count] != rec["est_c2w_before"][
            :count]).flatten(1).any(1)
        prog_win = set(torch.nonzero(moved).flatten().tolist())
        ref_win = {s for s, w in zip(slots, pose_mask.tolist())
                   if s >= 0 and w > 0}
        window_mismatch = len(prog_win ^ ref_win)
    opt = pose_mask > 0
    pose_gap = 0.0
    if bool(opt.any()):
        moved = (ref_c2w - prev_c2w)[:, :3].flatten(1).norm(dim=1)[opt]
        med = float(moved.median())
        gaps = (prog_c2w - ref_c2w)[:, :3].flatten(1).norm(dim=1)[opt]
        pose_gap = float((gaps / torch.clamp(moved, min=max(med, 1e-30)))
                         .max())
    return {"map_loss_gap": loss_gap, "map_step_gap": step_gaps[0],
            "map_steps_gap": max(step_gaps), "map_pose_gap": pose_gap,
            "window_mismatch": float(window_mismatch)}


def to_device(x, device):
    """A record's tensors (kept on the host) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [to_device(v, device) for v in x]
    return x


def compare(cfg: dict, seed: int, run: dict, source, device,
            dtype=torch.float32) -> dict:
    """Every compared number of a run (see the module's docstring).
    ``run``: ``track`` and ``map`` (the recorded group), ``init`` (the
    initial map), ``store`` (sampled slots), ``store_upto`` (the frames
    the store had seen), ``n_img``.  ``dtype`` is the reference's
    precision (bfloat16: the reference as a lower-precision control)."""
    frames = Frames(source)
    out = {"init_map_mismatch": float(check_init(cfg, seed, run["init"])),
           "store_mismatch": float(check_store(
               cfg, frames, run["n_img"], run["store_upto"], run["store"],
               run["map"]["packed"], "cpu"))}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["track_loss_gap"], out["track_step_gap"] = follow_tracking(
        cfg, to_device(run["track"], device), frames, dtype)
    out.update(follow_mapping(cfg, to_device(run["map"], device), frames,
                              run["n_img"], dtype))
    return out
