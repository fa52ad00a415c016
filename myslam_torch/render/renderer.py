"""SDF-density volumetric ray renderer.

Depth-guided sampling for rays with sensor depth; stratified plus
importance (inverse-CDF) sampling for depth-less rays; SDF -> alpha
compositing.  Every ray of a batch is rendered; rays the reference
filters out are masked in the loss instead.  The depth-less branch is
computed only when the caller says depth-less rays can occur
(``importance``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from myslam_torch.core.geometry import normalize_3d_coordinate, \
    ray_aabb_exit_t, rays_full_image
from myslam_torch.core.sampling import (
    depth_guided_z_vals,
    sample_pdf,
    uniform_z_vals,
)
from myslam_torch.models.decoders import decode_rgb_corners, \
    decode_sdf_corners
from myslam_torch.models.planes import MapState, PlaneLayout, \
    compute_bound, make_layout
from myslam_torch.ops.composite import (
    composite,
    composite_topk,
    composite_weights,
    sdf2alpha,
)
from myslam_torch.ops.plane_sample import (
    pack_quad,
    reduced_row_map,
    sample_fused,
)
from myslam_torch.utils import trace

_const_cache: dict = {}

# The importance branch's coarse passes (``build_z_vals_core``): passes,
# the rays given to the coarse pass and its SDF points.  Host integers
# from the tensors' shapes: no device read, no launch.
IMPORTANCE_COUNTS = {"passes": 0, "rays": 0, "points": 0}


def _row_map(layout: PlaneLayout, device) -> torch.Tensor:
    key = ("row_map", layout, str(device))
    if key not in _const_cache:
        _const_cache[key] = torch.as_tensor(
            reduced_row_map(layout)).to(device)
    return _const_cache[key]


@dataclass(frozen=True)
class SceneGeometry:
    """Static scene/rendering geometry shared by all render calls."""

    sdf_layout: PlaneLayout
    color_layout: PlaneLayout
    bound: tuple  # ((xmin, xmax), (ymin, ymax), (zmin, zmax))
    truncation: float
    n_stratified: int
    n_importance: int
    perturb: bool
    # Query the color field only at the color_topk highest-weight samples
    # per ray (0 = every sample, the reference's exact math).
    color_topk: int = 0

    def bound_tensor(self, device) -> torch.Tensor:
        """(3, 2) float32 bound on ``device``, cached (a fresh host->device
        copy per call would stall the stream)."""
        key = ("bound", self.bound, str(device))
        if key not in _const_cache:
            _const_cache[key] = torch.as_tensor(
                np.asarray(self.bound, np.float32)).to(device)
        return _const_cache[key]

    @property
    def n_samples(self) -> int:
        return self.n_stratified + self.n_importance


def scene_from_cfg(cfg: dict) -> SceneGeometry:
    """The scene of a config: its bound, the SDF and color plane layouts
    (coarse and fine), the truncation and the sampling schedule."""
    bound = compute_bound(cfg)
    c_dim = int(cfg["model"]["c_dim"])
    pres, cres = cfg["planes_res"], cfg["c_planes_res"]
    r = cfg["rendering"]
    return SceneGeometry(
        sdf_layout=make_layout(bound, [pres["coarse"], pres["fine"]], c_dim),
        color_layout=make_layout(bound, [cres["coarse"], cres["fine"]],
                                 c_dim),
        bound=tuple(map(tuple, bound.tolist())),
        truncation=float(cfg["model"]["truncation"]),
        n_stratified=int(r["n_stratified"]),
        n_importance=int(r["n_importance"]),
        perturb=bool(r["perturb"]),
        color_topk=int(r.get("color_topk", 0)))


class FieldQueries:
    """Query closures bound to one map: normalized points (N, 3) -> sdf
    (N,) or rgb (N, 3).  ``sdf_ng`` runs without autograd (the coarse
    importance pass)."""

    __slots__ = ("sdf", "rgb", "sdf_ng", "beta", "beta_ng")

    def __init__(self, sdf, rgb, sdf_ng, beta, beta_ng):
        self.sdf = sdf
        self.rgb = rgb
        self.sdf_ng = sdf_ng
        self.beta = beta
        self.beta_ng = beta_ng


def make_queries(ms: MapState, scene: SceneGeometry, sdf_quad=None,
                 color_quad=None, quad_dtype=None) -> FieldQueries:
    """FieldQueries over quad atlases (packed here when not given).

    ``quad_dtype`` (e.g. torch.bfloat16) casts the quads packed here:
    a read-precision cut between the f32 master atlases and the sample
    (mapping.map_bf16); the weighting and the losses stay f32.
    """
    if sdf_quad is None:
        sdf_quad = pack_quad(ms.sdf_atlas, scene.sdf_layout)
        if quad_dtype is not None:
            sdf_quad = sdf_quad.to(quad_dtype)
    if color_quad is None:
        color_quad = pack_quad(ms.color_atlas, scene.color_layout)
        if quad_dtype is not None:
            color_quad = color_quad.to(quad_dtype)
    dev = sdf_quad.device
    rm_sdf = _row_map(scene.sdf_layout, dev)
    rm_color = _row_map(scene.color_layout, dev)
    dec = ms.decoder

    def sdf(p):
        return decode_sdf_corners(
            dec, sample_fused(sdf_quad, scene.sdf_layout, p), rm_sdf)

    def rgb(p):
        return decode_rgb_corners(
            dec, sample_fused(color_quad, scene.color_layout, p), rm_color)

    def sdf_ng(p):
        with torch.no_grad():
            return sdf(p)

    return FieldQueries(sdf=sdf, rgb=rgb, sdf_ng=sdf_ng, beta=dec.beta[0],
                        beta_ng=dec.beta[0].detach())


def build_z_vals_core(draws, scene: SceneGeometry, rays_o, rays_d, gt_depth,
                      importance: bool, q: FieldQueries) -> torch.Tensor:
    """Per-ray sample depths (R, n_stratified + n_importance).

    Rays with depth get the depth-guided schedule.  With ``importance``,
    depth-less rays instead get stratified samples to the bound's exit
    plus inverse-CDF samples from a no-grad coarse SDF pass.  Draws, in
    order: the depth-guided jitter (if perturb); then, with importance,
    the uniform jitter (if perturb) and the pdf uniforms.
    """
    z_depth = depth_guided_z_vals(
        draws, gt_depth, scene.truncation, scene.n_stratified,
        scene.n_importance, scene.perturb)
    if not importance:
        return z_depth
    n_rays = rays_o.shape[0]
    IMPORTANCE_COUNTS["passes"] += 1
    IMPORTANCE_COUNTS["rays"] += n_rays
    IMPORTANCE_COUNTS["points"] += n_rays * scene.n_stratified
    with trace.span("render.importance"):
        bound = scene.bound_tensor(rays_o.device)
        rays_o_ng = rays_o.detach()
        rays_d_ng = rays_d.detach()
        far = ray_aabb_exit_t(rays_o_ng, rays_d_ng, bound) + 0.01
        z_uni = uniform_z_vals(draws, far, scene.n_stratified, scene.perturb)
        pts_uni = (rays_o_ng[:, None, :]
                   + rays_d_ng[:, None, :] * z_uni[..., None])
        p_nor = normalize_3d_coordinate(pts_uni.reshape(-1, 3), bound)
        sdf_uni = q.sdf_ng(p_nor).reshape(z_uni.shape)
        alpha_uni = sdf2alpha(sdf_uni, q.beta_ng)
        w_uni = composite_weights(alpha_uni)
        z_mid = 0.5 * (z_uni[..., 1:] + z_uni[..., :-1])
        z_samples = sample_pdf(draws, z_mid, w_uni[..., 1:-1],
                               scene.n_importance)
        z_nodepth = torch.sort(torch.cat([z_uni, z_samples], dim=-1),
                               dim=-1).values
    return torch.where((gt_depth > 0)[:, None], z_depth, z_nodepth)


def sample_points(draws, scene: SceneGeometry, rays_o, rays_d, gt_depth,
                  importance: bool, q: FieldQueries):
    """render_core's first stage: the sample depths z_vals (R, N), their
    world points (R, N, 3) and normalized points (R * N, 3)."""
    z_vals = build_z_vals_core(draws, scene, rays_o, rays_d, gt_depth,
                               importance, q)
    bound = scene.bound_tensor(rays_o.device)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    p_nor = normalize_3d_coordinate(pts.reshape(-1, 3), bound)
    return z_vals, pts, p_nor


def shade(scene: SceneGeometry, q: FieldQueries, sdf, z_vals, pts, p_nor):
    """render_core's last stage: alpha from the SDF (R, N), the color
    field at the composited samples (the top K, or all), compositing ->
    (depth (R,), color (R, 3))."""
    alpha = sdf2alpha(sdf, q.beta)
    K = int(scene.color_topk)
    if K and K < scene.n_samples:
        bound = scene.bound_tensor(pts.device)
        return composite_topk(
            alpha, z_vals, pts,
            lambda p: q.rgb(normalize_3d_coordinate(p, bound)), K)
    rgb = q.rgb(p_nor).reshape(z_vals.shape + (3,))
    depth, color, _ = composite(alpha, z_vals, rgb)
    return depth, color


def render_core(draws, scene: SceneGeometry, rays_o, rays_d, gt_depth,
                importance: bool, q: FieldQueries):
    """Render a ray batch: (depth (R,), color (R, 3), sdf (R, N),
    z_vals (R, N)).  The stages: sample_points, the SDF field at every
    sample, shade."""
    z_vals, pts, p_nor = sample_points(draws, scene, rays_o, rays_d,
                                       gt_depth, importance, q)
    sdf = q.sdf(p_nor).reshape(z_vals.shape)
    depth, color = shade(scene, q, sdf, z_vals, pts, p_nor)
    return depth, color, sdf, z_vals


def render_rays(draws, ms: MapState, scene: SceneGeometry, rays_o, rays_d,
                gt_depth, importance: bool, sdf_quad=None, color_quad=None):
    """render_core against a MapState.  Pass pre-packed quads when the
    map is frozen over many calls (tracking)."""
    q = make_queries(ms, scene, sdf_quad=sdf_quad, color_quad=color_quad)
    return render_core(draws, scene, rays_o, rays_d, gt_depth, importance, q)


def query_sdf(ms: MapState, scene: SceneGeometry, p_nor, sdf_quad=None):
    """Raw SDF (N,) at normalized points."""
    if sdf_quad is None:
        sdf_quad = pack_quad(ms.sdf_atlas, scene.sdf_layout)
    corners = sample_fused(sdf_quad, scene.sdf_layout, p_nor)
    return decode_sdf_corners(ms.decoder, corners,
                              _row_map(scene.sdf_layout, p_nor.device))


def query_rgb(ms: MapState, scene: SceneGeometry, p_nor, color_quad=None):
    """Raw RGB (N, 3) at normalized points."""
    if color_quad is None:
        color_quad = pack_quad(ms.color_atlas, scene.color_layout)
    corners = sample_fused(color_quad, scene.color_layout, p_nor)
    return decode_rgb_corners(ms.decoder, corners,
                              _row_map(scene.color_layout, p_nor.device))


def query_raw(ms: MapState, scene: SceneGeometry, pts, sdf_quad=None,
              color_quad=None):
    """World points (..., 3) -> (..., 4) [rgb, sdf]."""
    shape = pts.shape
    p_nor = normalize_3d_coordinate(pts.reshape(-1, 3),
                                    scene.bound_tensor(pts.device))
    sdf = query_sdf(ms, scene, p_nor, sdf_quad)
    rgb = query_rgb(ms, scene, p_nor, color_quad)
    return torch.cat([rgb, sdf[:, None]], dim=-1).reshape(
        shape[:-1] + (4,))


def make_image_renderer(scene: SceneGeometry, cam,
                        ray_batch_size: int = 40960):
    """The full-frame renderer without gradients: every pixel's ray, in
    chunks of ``ray_batch_size``.

    The pixels are padded to whole chunks with rays of origin 0,
    direction 1 and depth 0, as the JAX package pads them, so every
    chunk's draws have its shapes (at 680x1200, 20 chunks of 40,960 with
    3,200 pad rays).  Both atlases are packed to float32
    quads once per call; depth-less rays (the pad's too) take the coarse
    no-gradient SDF pass (``importance``), and color is composited over
    every sample (no top-K).  Each chunk launches the sample three times:
    the coarse pass, then the SDF and the color field at every sample.
    Intermediates are released chunk by chunk.

    Returns render_img(ms, c2w (4, 4), gt_depth (H, W), draws) ->
    (depth (H, W), color (H, W, 3)) on c2w's device.  Draws, per chunk in
    order: build_z_vals_core's.
    """
    n_px = cam.H * cam.W
    # A chunk is never larger than the image (JAX pads a small image up
    # to one whole chunk: its pad rays are rendered and dropped).
    ray_batch_size = min(ray_batch_size, n_px)
    n_chunks = -(-n_px // ray_batch_size)
    pad = n_chunks * ray_batch_size - n_px

    @torch.no_grad()
    def render_img(ms: MapState, c2w, gt_depth, draws):
        dev = c2w.device
        rays_o, rays_d = rays_full_image(cam.H, cam.W, cam.fx, cam.fy,
                                         cam.cx, cam.cy, c2w)
        rays_o = torch.cat([rays_o.reshape(-1, 3),
                            torch.zeros((pad, 3), device=dev)])
        rays_d = torch.cat([rays_d.reshape(-1, 3),
                            torch.ones((pad, 3), device=dev)])
        depth_flat = torch.cat([gt_depth.reshape(-1).to(torch.float32),
                                torch.zeros((pad,), device=dev)])
        sdf_quad = pack_quad(ms.sdf_atlas, scene.sdf_layout)
        color_quad = pack_quad(ms.color_atlas, scene.color_layout)
        q = make_queries(ms, scene, sdf_quad=sdf_quad, color_quad=color_quad)
        depths, colors = [], []
        for c in range(n_chunks):
            s = slice(c * ray_batch_size, (c + 1) * ray_batch_size)
            ro, rd = rays_o[s], rays_d[s]
            z, pts, p_nor = sample_points(draws, scene, ro, rd,
                                          depth_flat[s], True, q)
            sdf = q.sdf(p_nor).reshape(z.shape)
            rgb = q.rgb(p_nor).reshape(z.shape + (3,))
            del pts, p_nor
            depth, color, _ = composite(sdf2alpha(sdf, q.beta), z, rgb)
            depths.append(depth)
            colors.append(color)
        depth_img = torch.cat(depths)[:n_px].reshape(cam.H, cam.W)
        color_img = torch.cat(colors)[:n_px].reshape(cam.H, cam.W, 3)
        return depth_img, color_img

    return render_img
