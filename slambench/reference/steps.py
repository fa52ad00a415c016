"""The plain reference's steps: a tracking iteration, a mapping iteration,
Adam, the keyframe window, the keyframe imagery and the initial map.

Each takes the state the program started the step from and the inputs
the benchmark made (the frames) or the program drew at random (pixels,
uniforms), and works out the step's result itself.  Plain PyTorch and
NumPy; it imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slambench.reference.field import Field, box_exit, color_loss, \
    depth_loss, masked_median, matrix_to_pose, pose_to_matrix, rays, \
    render, sdf_loss


class Draws:
    """Hands out the program's recorded draws in its order, each checked
    against the shape asked for."""

    def __init__(self, draws: list):
        self.draws = list(draws)
        self.k = 0

    def __call__(self, shape=None):
        if self.k >= len(self.draws):
            raise ValueError("the reference asked for more draws than the "
                             "program made")
        t = self.draws[self.k]
        self.k += 1
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"draw {self.k - 1} has shape {tuple(t.shape)}"
                             f", the reference asked for {tuple(shape)}")
        return t


class Adam:
    """torch.optim.Adam's update (bias-corrected, eps outside the root)
    over named leaves in groups of one learning rate each."""

    def __init__(self, groups: list, betas=(0.9, 0.999), eps=1e-8):
        self.groups = groups  # [(lr, [names])]
        self.b1, self.b2 = betas
        self.eps = eps
        self.m: dict = {}
        self.v: dict = {}
        self.t = 0

    def step(self, params: dict, grads: dict) -> dict:
        """The parameters after one step from ``params`` along
        ``grads``."""
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        out = {}
        for lr, names in self.groups:
            for n in names:
                g = grads[n]
                m = self.m.get(n, torch.zeros_like(g))
                v = self.v.get(n, torch.zeros_like(g))
                m = self.b1 * m + (1 - self.b1) * g
                v = self.b2 * v + (1 - self.b2) * g * g
                self.m[n], self.v[n] = m, v
                den = v.sqrt() / math.sqrt(bc2) + self.eps
                out[n] = params[n] - (lr / bc1) * m / den
        return out


def encode(color: np.ndarray, depth: np.ndarray):
    """A frame's imagery as the loop receives it: colour as rounded
    bytes, depth as 16-bit steps of 1 / q with q = 60000 / max depth (a
    valid depth never rounds to 0, which marks a hole), and 1 / q."""
    q = 60000.0 / max(float(depth.max()) if depth.size else 0.0, 1e-3)
    d16 = np.where(depth > 0, np.clip(np.rint(depth * q), 1, 65535),
                   0).astype(np.uint16)
    c8 = np.clip(np.rint(color * 255.0), 0, 255).astype(np.uint8)
    return c8, d16, 1.0 / q


def init_map(cfg: dict, seed: int, rows_sdf: int, rows_rgb: int):
    """The map a run starts from: a CPU generator seeded with ``seed``
    draws the decoders (nn.Linear's U(+-1/sqrt(fan_in)), weight then bias,
    SDF blocks, colour blocks, the SDF head, the colour head; beta 10),
    then the SDF and colour planes ~ N(0, 0.01^2)."""
    gen = torch.Generator().manual_seed(int(seed))
    c = int(cfg["model"]["c_dim"])
    dims = [(2 * c, 16), (16, 16)]
    dec = {}
    layers = ([(f"sdf.{k}", a, b) for k, (a, b) in enumerate(dims)]
              + [(f"rgb.{k}", a, b) for k, (a, b) in enumerate(dims)]
              + [("sdf_out", 16, 1), ("rgb_out", 16, 3)])
    for name, fan_in, fan_out in layers:
        bound = 1.0 / math.sqrt(fan_in)
        for part, shape in (("weight", (fan_out, fan_in)),
                            ("bias", (fan_out,))):
            u = torch.rand(shape, generator=gen)
            dec[f"{name}.{part}"] = (2.0 * u - 1.0) * bound
    dec["beta"] = torch.tensor([10.0])
    planes = 0.01 * torch.randn((rows_sdf, c), generator=gen)
    planes_c = 0.01 * torch.randn((rows_rgb, c), generator=gen)
    return planes, planes_c, dec


def track_loss(cfg: dict, field: Field, pose, i, j, px_color, px_depth,
               draws):
    """A tracking iteration's loss at ``pose`` (7,) on pixels (i, j) with
    their colour (n, 3) in [0, 1] and depth (n,): rays leaving the box
    before their depth, depth-less rays and rays whose depth error is
    over 10x the median are left out."""
    t = cfg["tracking"]
    cam = cfg["cam"]
    c2w = pose_to_matrix(pose[None])[0]
    o, d = rays(i, j, c2w, cam)
    inside = (box_exit(o.detach(), d.detach(), field.bound) >= px_depth) & (
        px_depth > 0)
    depth, color, sdf, z = render(field, cfg, o, d, px_depth, False, draws)
    err = torch.abs(px_depth - depth.detach())
    mask = inside & (err < 10.0 * masked_median(err, inside))
    trunc = float(cfg["model"]["truncation"])
    return (sdf_loss(sdf, z, px_depth, mask, trunc, float(t["w_sdf_fs"]),
                     float(t["w_sdf_center"]), float(t["w_sdf_tail"]))
            + float(t["w_color"]) * color_loss(px_color, color, mask)
            + float(t["w_depth"]) * depth_loss(px_depth, depth, mask))


def map_loss(cfg: dict, field: Field, poses, pose_mask, kf_of_slot,
             n_slots: int, colors, depths, importance: bool, draws):
    """A mapping iteration's loss: ``mapping.pixels`` rays, ray r from
    window slot r % n_slots, at pixel columns then rows drawn by the
    program; the slot's imagery ``colors`` (K, H, W, 3) in [0, 1] and
    ``depths`` (K, H, W) indexed by ``kf_of_slot``.  Poses (W, 7) whose
    mask is 0 are held fixed."""
    m = cfg["mapping"]
    cam = cfg["cam"]
    n = int(m["pixels"])
    poses = torch.where(pose_mask[:, None] > 0, poses, poses.detach())
    c2ws = pose_to_matrix(poses)
    slot = torch.arange(n, device=poses.device) % n_slots
    i = draws((n,)).to(torch.float32)
    j = draws((n,)).to(torch.float32)
    kf = kf_of_slot[slot]
    px_depth = depths[kf, j.long(), i.long()]
    px_color = colors[kf, j.long(), i.long()]
    o, d = rays(i, j, c2ws[slot], cam)
    inside = box_exit(o.detach(), d.detach(), field.bound) >= px_depth
    depth, color, sdf, z = render(field, cfg, o, d, px_depth, importance,
                                  draws)
    dmask = inside & (px_depth > 0)
    trunc = float(cfg["model"]["truncation"])
    return (sdf_loss(sdf, z, px_depth, dmask, trunc, float(m["w_sdf_fs"]),
                     float(m["w_sdf_center"]), float(m["w_sdf_tail"]))
            + float(m["w_color"]) * color_loss(px_color, color, inside)
            + float(m["w_depth"]) * depth_loss(px_depth, depth, dmask))


def select_window(cfg: dict, kf_c2w, count: int, cur_c2w, cur_depth,
                  draws, joint_opt: bool, capacity: int):
    """The mapping window: up to window_size - 1 random keyframes older
    than the last two whose frustum holds some of 400 surface samples of
    the current frame (50 pixels, 8 depths from 0.8 d to d + 0.5, 20
    pixels of margin), the last two, then the current frame.  Returns
    the window's store slots (the current frame as -1), in order, and
    which of them have their poses optimised."""
    cam = cfg["cam"]
    H, W = int(cam["H"]), int(cam["W"])
    ws = int(cfg["mapping"]["mapping_window_size"])
    dev = kf_c2w.device
    j = draws((50,)).to(torch.float32)
    i = draws((50,)).to(torch.float32)
    d = cur_depth[j.long(), i.long()]
    o, dirs = rays(i, j, cur_c2w, cam)
    t = torch.arange(7, dtype=torch.float32, device=dev) * (1.0 / 7)
    t = torch.cat([t, torch.ones(1, device=dev)])
    z = 0.8 * d[:, None] * (1 - t)[None] + (d[:, None] + 0.5) * t[None]
    pts = (o[:, None] + dirs[:, None] * z[..., None]).reshape(-1, 3)
    ok = (d > 0).repeat_interleave(8)
    # Each keyframe's w2c as one (4, 4) matrix, then the points in its
    # frame: the same operations in the same order as the program's,
    # since a point on a frustum's edge decides whether a keyframe may
    # join the window.
    Rt = kf_c2w[:, :3, :3].transpose(-1, -2)
    tw = -torch.matmul(Rt, kf_c2w[:, :3, 3].unsqueeze(-1)).squeeze(-1)
    w2c = torch.cat([torch.cat([Rt, tw[..., None]], -1),
                     kf_c2w.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
                         kf_c2w.shape[:-2] + (1, 4))], -2)[:, None]
    pc = torch.matmul(w2c[..., :3, :3], pts[None].unsqueeze(-1)).squeeze(
        -1) + w2c[..., :3, 3]
    x, y, zc = -pc[..., 0], pc[..., 1], pc[..., 2]
    zs = zc + 1e-5
    u = (cam["fx"] * x + cam["cx"] * zc) / zs
    v = (cam["fy"] * y + cam["cy"] * zc) / zs
    inside = ((u < W - 20) & (u > 20) & (v < H - 20) & (v > 20) & (zc < 0)
              & ok[None])
    score = inside.sum(1) / torch.clamp(ok.sum(), min=1)
    ids = torch.arange(capacity, device=dev)
    eligible = (score > 0) & (ids < count - 2)
    r = draws((capacity,))
    rank = torch.where(eligible, r, torch.full_like(r, -float("inf")))
    top = torch.topk(rank, min(ws - 1, capacity)).indices
    chosen = torch.zeros(capacity, dtype=torch.bool, device=dev)
    chosen[top] = eligible[top]
    if count > 1:
        chosen[count - 2:count] = True
    slots = ids[chosen].tolist() + [-1]
    mask = [0.0] + [float(joint_opt)] * (len(slots) - 1)
    return slots, torch.tensor(mask, device=dev)


def poses_of(c2ws) -> torch.Tensor:
    return matrix_to_pose(c2ws)
