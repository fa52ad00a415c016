"""The plain reference's field: rays, sample depths, the tri-plane
features, the decoders, compositing and the losses, in plain PyTorch.

Written from ESLAM's equations (Johari et al., CVPR 2023) as the JAX
package states them, with the port's conventions for what is a choice
rather than the mathematics (the camera's -z convention, the depth-guided
schedule, the reference's unnormalised pdf).  It samples the feature
planes directly, four corner rows per plane by ``index_select``, with no
packed quads and no kernels, and computes in ``dtype`` (float32; the
control passes bfloat16 for the features and decoders).  It imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# (u-axis, v-axis) of the planes xy, xz, yz; u indexes a plane's width.
ORIENTATIONS = ((0, 1), (0, 2), (1, 2))


# -- poses ----------------------------------------------------------------


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3), rescaled by 2 / |q|^2."""
    w, x, y, z = q.unbind(-1)
    s = 2.0 / (q * q).sum(-1)
    m = torch.stack([
        1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w),
        s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w),
        s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz by the dominant of Shepperd's four
    candidates."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    m01, m02, m10 = m[..., 0, 1], m[..., 0, 2], m[..., 1, 0]
    m12, m20, m21 = m[..., 1, 2], m[..., 2, 0], m[..., 2, 1]
    sq = torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    a = torch.sqrt(torch.clamp(sq, min=0.0))
    cands = torch.stack([
        torch.stack([a[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, a[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, a[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, a[..., 3] ** 2], -1),
    ], -2) / (2.0 * torch.clamp(a, min=1e-8))[..., None]
    best = sq.argmax(-1)
    return torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4))).squeeze(-2)


def pose_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """(..., 7) [quaternion wxyz, translation] -> (..., 4, 4)."""
    top = torch.cat([quaternion_to_matrix(pose[..., :4]),
                     pose[..., 4:, None]], -1)
    bottom = pose.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        pose.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], -2)


def matrix_to_pose(c2w: torch.Tensor) -> torch.Tensor:
    return torch.cat([matrix_to_quaternion(c2w[..., :3, :3]),
                      c2w[..., :3, 3]], -1)


# -- rays and the scene's box -----------------------------------------------


def rays(i, j, c2w, cam: dict):
    """World rays (origins, directions) for pixel columns i and rows j
    under c2w (..., 4, 4): camera directions [(i-cx)/fx, -(j-cy)/fy, -1]."""
    dirs = torch.stack([(i - cam["cx"]) / cam["fx"],
                        -(j - cam["cy"]) / cam["fy"], -torch.ones_like(i)],
                       -1)
    d = torch.matmul(c2w[..., :3, :3], dirs[..., None])[..., 0]
    return c2w[..., :3, 3].expand(d.shape), d


def box_exit(o, d, bound):
    """t of each ray's exit of the box ``bound`` (3, 2)."""
    t = (bound[None] - o[:, :, None]) / d[:, :, None]
    return t.amax(2).amin(1)


def scene_bound(cfg: dict) -> np.ndarray:
    """The map's box: ``mapping.bound`` with each upper edge raised to a
    whole number of ``planes_res.bound_dividable`` steps above the lower
    one, plus one step."""
    b = np.array(cfg["mapping"]["bound"], np.float64) * cfg.get("scale", 1)
    div = cfg["planes_res"]["bound_dividable"]
    b[:, 1] = (((b[:, 1] - b[:, 0]) / div).astype(int) + 1) * div + b[:, 0]
    return b.astype(np.float32)


def plane_shapes(bound: np.ndarray, resolutions) -> list:
    """Per level, per orientation (H, W, first row) of the field's planes
    stored one after another, rows of c_dim features."""
    length = (bound[:, 1] - bound[:, 0]).tolist()
    out, off = [], 0
    for res in resolutions:
        nx, ny, nz = (int(v / res) for v in length)
        level = []
        for h, w in ((ny, nx), (nz, nx), (nz, ny)):
            level.append((h, w, off))
            off += h * w
        out.append(level)
    return out


# -- sample depths ----------------------------------------------------------


def linspace01(n: int, device) -> torch.Tensor:
    if n == 1:
        return torch.zeros(1, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) * (
        1.0 / (n - 1))
    return torch.cat([t, torch.ones(1, device=device)])


def jitter(z, u):
    """Stratified jitter of sorted depths z by uniforms u within their
    intervals."""
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], -1)
    lower = torch.cat([z[..., :1], mids], -1)
    return lower + (upper - lower) * u


def depth_guided(depth, trunc, n_strat, n_imp, u):
    """n_strat free-space depths on [0, 1.2 d] and n_imp on d +- 1.5
    trunc, sorted, jittered by u (None: no jitter)."""
    dev = depth.device
    d = depth[:, None]
    z = torch.cat([1.2 * d * linspace01(n_strat, dev)[None],
                   d - 1.5 * trunc + 3.0 * trunc
                   * linspace01(n_imp, dev)[None]], -1)
    z = torch.sort(z, -1).values
    return z if u is None else jitter(z, u)


def pdf_samples(bins, weights, u):
    """Inverse-CDF samples at uniforms u (N, k) of the unnormalised
    weights (N, M) over bins (N, M+1), as ESLAM keeps it."""
    cdf = torch.cumsum(weights, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0, b1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    den = c1 - c0
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


# -- the field ----------------------------------------------------------------


class Field:
    """One map's two fields, read in ``dtype``: ``planes`` (rows, c_dim)
    and ``planes_c`` of the SDF and colour levels, and the decoders'
    parameters ``dec`` (a dict of the port's names ``sdf.0.weight`` ...
    ``rgb_out.bias`` and ``beta``)."""

    def __init__(self, cfg: dict, planes, planes_c, dec: dict,
                 dtype=torch.float32):
        self.bound_np = scene_bound(cfg)
        self.bound = torch.as_tensor(self.bound_np, device=planes.device)
        self.sdf_planes = plane_shapes(self.bound_np, [
            cfg["planes_res"]["coarse"], cfg["planes_res"]["fine"]])
        self.rgb_planes = plane_shapes(self.bound_np, [
            cfg["c_planes_res"]["coarse"], cfg["c_planes_res"]["fine"]])
        self.planes, self.planes_c, self.dec = planes, planes_c, dec
        self.dtype = dtype

    def normalize(self, p):
        lo, hi = self.bound[:, 0], self.bound[:, 1]
        return (p - lo) / (hi - lo) * 2.0 - 1.0

    def features(self, atlas, layout, p):
        """Bilinear features (N, levels * c_dim) at normalized points p:
        grid_sample's align_corners=True with the border clamp, summed
        over the three planes of a level."""
        a = atlas.to(self.dtype)
        out = []
        for level in layout:
            acc = 0
            for (au, av), (H, W, off) in zip(ORIENTATIONS, level):
                x = torch.clamp((p[:, au] + 1.0) * 0.5 * (W - 1.0), 0.0,
                                W - 1.0)
                y = torch.clamp((p[:, av] + 1.0) * 0.5 * (H - 1.0), 0.0,
                                H - 1.0)
                x0, y0 = torch.floor(x), torch.floor(y)
                fx, fy = (x - x0)[:, None], (y - y0)[:, None]
                x0, y0 = x0.long(), y0.long()
                x1 = torch.clamp(x0 + 1, max=W - 1)
                y1 = torch.clamp(y0 + 1, max=H - 1)

                def row(yy, xx):
                    return a.index_select(0, off + yy * W + xx)

                acc = acc + (row(y0, x0) * ((1 - fx) * (1 - fy)).to(a.dtype)
                             + row(y0, x1) * (fx * (1 - fy)).to(a.dtype)
                             + row(y1, x0) * ((1 - fx) * fy).to(a.dtype)
                             + row(y1, x1) * (fx * fy).to(a.dtype))
            out.append(acc)
        return torch.cat(out, -1)

    def mlp(self, name, out_name, feat):
        h = feat
        for k in range(2):
            h = F.relu(F.linear(h, self.dec[f"{name}.{k}.weight"].to(
                self.dtype), self.dec[f"{name}.{k}.bias"].to(self.dtype)))
        return F.linear(h, self.dec[f"{out_name}.weight"].to(self.dtype),
                        self.dec[f"{out_name}.bias"].to(self.dtype))

    def sdf(self, p):
        f = self.features(self.planes, self.sdf_planes, p)
        return torch.tanh(self.mlp("sdf", "sdf_out", f))[..., 0].float()

    def rgb(self, p):
        f = self.features(self.planes_c, self.rgb_planes, p)
        return torch.sigmoid(self.mlp("rgb", "rgb_out", f)).float()


def alpha_of(sdf, beta):
    return 1.0 - torch.exp(-beta * torch.sigmoid(-sdf * beta))


def weights_of(alpha):
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alpha * trans


def render(field: Field, cfg: dict, o, d, depth, importance: bool, draws):
    """Depth (R,), colour (R, 3), sdf (R, S) and sample depths (R, S) of
    the rays.  Rays with depth take the depth-guided schedule; with
    ``importance`` depth-less rays take stratified samples to the box's
    exit plus inverse-CDF samples of a coarse SDF pass.  ``draws()``
    hands out the recorded uniforms in the program's order."""
    r = cfg["rendering"]
    n_s, n_i = int(r["n_stratified"]), int(r["n_importance"])
    trunc = float(cfg["model"]["truncation"])
    perturb = bool(r["perturb"])
    z = depth_guided(depth, trunc, n_s, n_i, draws() if perturb else None)
    beta = field.dec["beta"][0]
    if importance:
        o_ng, d_ng = o.detach(), d.detach()
        far = box_exit(o_ng, d_ng, field.bound) + 0.01
        t = linspace01(n_s, far.device)
        zu = far[:, None] * t[None]
        if perturb:
            zu = jitter(zu, draws())
        with torch.no_grad():
            pts = o_ng[:, None] + d_ng[:, None] * zu[..., None]
            s_u = field.sdf(field.normalize(pts.reshape(-1, 3))).reshape(
                zu.shape)
            w_u = weights_of(alpha_of(s_u, beta.detach()))
        zs = pdf_samples(0.5 * (zu[..., 1:] + zu[..., :-1]), w_u[..., 1:-1],
                         draws())
        z_nd = torch.sort(torch.cat([zu, zs], -1), -1).values
        z = torch.where((depth > 0)[:, None], z, z_nd)
    pts = o[:, None] + d[:, None] * z[..., None]
    p = field.normalize(pts.reshape(-1, 3))
    sdf = field.sdf(p).reshape(z.shape)
    w = weights_of(alpha_of(sdf, beta))
    rgb = field.rgb(p).reshape(z.shape + (3,))
    return (w * z).sum(-1), (w[..., None] * rgb).sum(-2), sdf, z


# -- losses -------------------------------------------------------------------


def masked_mean(x, m):
    m = m.to(x.dtype)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def sdf_loss(sdf, z, depth, mask, trunc, w_fs, w_c, w_t):
    """ESLAM's free-space, centre and tail SDF terms, weighted."""
    d, rm = depth[:, None], mask[:, None]
    front = (z < d - trunc) & rm
    back = (z > d + trunc) & rm
    center = (z > d - 0.4 * trunc) & (z < d + 0.4 * trunc) & rm
    tail = ~front & ~back & ~center & rm
    est = z + sdf * trunc
    return (w_fs * masked_mean(torch.square(sdf - 1.0), front)
            + w_c * masked_mean(torch.square(est - d), center)
            + w_t * masked_mean(torch.square(est - d), tail))


def color_loss(gt, c, mask):
    sq = torch.square(gt - c)
    return masked_mean(sq, mask[:, None].expand(sq.shape))


def depth_loss(gt, d, mask):
    return masked_mean(torch.square(gt - d), mask)


def masked_median(x, mask):
    """sorted[(n - 1) // 2] of the masked values (+inf when none)."""
    n = mask.sum()
    vals = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))))
    return vals.values.gather(0, (torch.clamp(n - 1, min=0) // 2)
                              .reshape(1))[0]
