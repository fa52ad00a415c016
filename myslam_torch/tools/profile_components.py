#!/usr/bin/env python
"""The mapping iteration split by component, on the card.

    python -m myslam_torch.tools.profile_components [--config PATH]
        [--iters 10] [--topk -1] [--device cpu] [--json]

The counterpart of ``myslam_tpu/tools/profile_components.py``, at its
operating point (``configs/Synthetic/room.yaml``: 680x1200, 4,000 rays
(``mapping.pixels``), 40 samples, top-K color from the config or
``--topk``, the config's quad read precision) and on the port's
production code (``engine/mapper._build_core``'s loss, and the stages
it runs in order: ``_build_stages``' geometry, the renderer's
``sample_points``, the SDF field, ``shade``, ``_build_stages``'
losses), over a window of ``mapping_window_size`` keyframes
of constant imagery with every pose at the bound's center:

  full_grad   the loss and its gradient: one mapping iteration without
              the optimizer step
  forward     the loss alone, its autograd graph recorded (backward_ms =
              full_grad - forward)
  raygen      geometry (pixel draw, pixel reads, rays), the quads'
              pack, sample_points (z values, points, normalize)
  sdf_field   raygen + the SDF field at every sample (sample + decode)
  rgb_field   sdf_field + shade (the color field at the composited
              samples, top-K or all, and the compositing)
  mlp_only    both decoders on pre-sampled corner features
  composite   sdf2alpha, compositing and losses on fixed fields
  adam        the mapping step's dense Adam update of the atlases,
              decoders and window poses (``make_map_optimizer``), on
              full_grad's gradients: what ray DP replicates on every rank
              and ``zero_opt`` shards
  track_frame one frame's tracking (``tracking.iters`` iterations of the
              loss, the pose gradient and Adam over ``tracking.pixels``
              pixels against the frozen quads; ``track_iter_ms`` is its
              ms over the iterations)

The JAX tool timed each component as a scan inside one program.  Here
each reports, per call: ``ms``, CUDA events over ``--iters`` calls made
one after another, after a synchronize (the host's launch rate
included); ``device_ms``, the device time of its kernels and copies in
a torch.profiler trace of the same number of calls; and ``launches``,
the kernels it launches.  The field components run without autograd.
On the CPU (``--device cpu``) ``ms`` is the host clock and the other
two are None.
"""

from __future__ import annotations

import argparse
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COMPONENTS = ("full_grad", "forward", "raygen", "sdf_field", "rgb_field",
              "mlp_only", "composite", "adam", "track_frame")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(
        REPO, "configs", "Synthetic", "room.yaml"))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--topk", type=int, default=-1,
                    help="override rendering.color_topk (-1 = config)")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' to rehearse")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from myslam_torch import resolve_device
    from myslam_torch.core.quaternion import matrix_to_cam_pose
    from myslam_torch.core.sampling import TorchDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.engine.mapper import _build_core, _build_stages, \
        make_map_optimizer, map_quad_dtype
    from myslam_torch.engine.tracker import make_track_core, \
        pack_tracking_quads
    from myslam_torch.models.config import get_model
    from myslam_torch.models.decoders import decode_rgb_corners, \
        decode_sdf_corners
    from myslam_torch.models.planes import init_map_state
    from myslam_torch.ops.composite import composite, sdf2alpha
    from myslam_torch.ops.plane_sample import pack_quad, sample_fused
    from myslam_torch.render.renderer import _row_map, make_queries, \
        sample_points, scene_from_cfg, shade
    from myslam_torch.tools.devtime import profile_calls, time_ms
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    dev = resolve_device(args.device)
    cfg = load_config(args.config, DEFAULT_CONFIG)
    if args.topk >= 0:
        cfg["rendering"]["color_topk"] = args.topk
    cam = Camera.from_cfg(cfg)
    scene = scene_from_cfg(cfg)
    m = cfg["mapping"]
    n_rays = int(m["pixels"])
    quad_dtype = map_quad_dtype(cfg)
    gen = torch.Generator().manual_seed(0)
    ms = init_map_state(gen, scene.sdf_layout, scene.color_layout,
                        get_model(cfg, gen), device=dev)
    W = int(m["mapping_window_size"])
    bound = scene.bound_tensor(dev)
    c2ws = torch.eye(4, device=dev).repeat(W, 1, 1)
    c2ws[:, :3, 3] = bound.mean(dim=1)
    poses = matrix_to_cam_pose(c2ws).requires_grad_()
    pose_mask = torch.ones((W,), device=dev)
    pose_mask[0] = 0.0
    slot_kf = torch.arange(W, device=dev)
    kf_colors = torch.full((W, cam.H, cam.W, 3), 0.5, dtype=torch.float16,
                           device=dev)
    kf_depths = torch.full((W, cam.H, cam.W), 1.5, device=dev)
    draws = TorchDraws(0, dev)
    # The loop's own loss and its stages: each component below runs a
    # prefix of loss_fn's stages in its order.
    loss_fn, _ = _build_core(cfg, scene, cam, importance=False)
    geometry, losses = _build_stages(cfg, scene, cam)
    dec = ms.decoder
    params = [ms.sdf_atlas, ms.color_atlas, *dec.mlp_params(), dec.beta,
              poses]

    def loss():
        return loss_fn(ms, poses, pose_mask, slot_kf, W, kf_colors,
                       kf_depths, None, draws)

    def raygen():
        """geometry, then render_core's sample_points."""
        rays_o, rays_d, px_depth, _, _ = geometry(
            poses, pose_mask, slot_kf, W, kf_colors, kf_depths, None, draws)
        q = make_queries(ms, scene, quad_dtype=quad_dtype)
        return q, sample_points(draws, scene, rays_o, rays_d, px_depth,
                                False, q)

    def sdf_field():
        q, (z_vals, pts, p_nor) = raygen()
        return q, z_vals, pts, p_nor, q.sdf(p_nor).reshape(z_vals.shape)

    def rgb_field():
        q, z_vals, pts, p_nor, sdf = sdf_field()
        return shade(scene, q, sdf, z_vals, pts, p_nor)

    n_pts = n_rays * scene.n_samples
    rng = np.random.default_rng(0)
    with torch.no_grad():
        p_fix = torch.as_tensor(rng.uniform(0.05, 0.95, (n_pts, 3)),
                                dtype=torch.float32).to(dev)
        sdf_corners = sample_fused(pack_quad(ms.sdf_atlas, scene.sdf_layout),
                                   scene.sdf_layout, p_fix)
        rgb_corners = sample_fused(
            pack_quad(ms.color_atlas, scene.color_layout),
            scene.color_layout, p_fix)
    rm_sdf = _row_map(scene.sdf_layout, dev)
    rm_color = _row_map(scene.color_layout, dev)

    def mlp_only():
        return (decode_sdf_corners(dec, sdf_corners, rm_sdf),
                decode_rgb_corners(dec, rgb_corners, rm_color))

    S = scene.n_samples
    sdf_fix = torch.as_tensor(np.random.default_rng(1).normal(
        size=(n_rays, S)), dtype=torch.float32).to(dev)
    rgb_fix = torch.full((n_rays, S, 3), 0.5, device=dev)
    z_fix = torch.linspace(0.5, 2.5, S, device=dev).repeat(n_rays, 1)
    d_fix = torch.full((n_rays,), 1.5, device=dev)
    c_fix = torch.full((n_rays, 3), 0.5, device=dev)
    mask_fix = torch.ones((n_rays,), dtype=torch.bool, device=dev)

    def composite_loss():
        alpha = sdf2alpha(sdf_fix, 10.0)
        depth, color, _ = composite(alpha, z_fix, rgb_fix)
        return losses(sdf_fix, z_fix, depth, color, d_fix, c_fix, mask_fix)

    # The Adam step on one iteration's gradients (set once; each call
    # updates the map again).
    opt = make_map_optimizer(cfg, ms, poses, 1.0)
    grads = torch.autograd.grad(loss(), params)
    for p, g in zip(params, grads):
        p.grad = g

    t = cfg["tracking"]
    t_iters, n_px = int(t["iters"]), int(t["pixels"])
    track = make_track_core(cfg, scene, cam)
    quads = pack_tracking_quads(ms, scene,
                                bool(t.get("map_bf16", True)))
    px_i = torch.randint(0, cam.W, (t_iters, n_px), generator=gen).to(dev)
    px_j = torch.randint(0, cam.H, (t_iters, n_px), generator=gen).to(dev)
    px_color = torch.full((t_iters, n_px, 3), 128, dtype=torch.uint8,
                          device=dev)
    px_depth = torch.full((t_iters, n_px), 1.5, device=dev)
    pose0 = poses[1].detach()

    def track_frame():
        return track(ms, quads, pose0, px_i, px_j, px_color, px_depth,
                     draws)

    no_grad = torch.no_grad()
    fns = {
        "full_grad": lambda: torch.autograd.grad(loss(), params),
        "forward": loss,
        "raygen": no_grad(raygen),
        "sdf_field": no_grad(sdf_field),
        "rgb_field": no_grad(rgb_field),
        "mlp_only": no_grad(mlp_only),
        "composite": no_grad(composite_loss),
        "adam": opt.step,
        "track_frame": track_frame,
    }
    report = {"device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "config": args.config, "cam": [cam.H, cam.W],
              "n_rays": n_rays, "n_samples": S,
              "color_topk": int(scene.color_topk),
              "map_bf16": quad_dtype is not None, "window": W,
              "iters": args.iters, "components": {}}
    for name in COMPONENTS:
        rec = {"ms": time_ms(fns[name], dev, args.iters),
               **profile_calls(fns[name], dev, args.iters)}
        report["components"][name] = rec
        if not args.json:
            print(f"{name}: {rec}", flush=True)
    comp = report["components"]
    report["backward_ms"] = comp["full_grad"]["ms"] - comp["forward"]["ms"]
    report["fwd_unaccounted_ms"] = (comp["forward"]["ms"]
                                    - comp["rgb_field"]["ms"])
    report["track_iters"] = t_iters
    report["track_iter_ms"] = comp["track_frame"]["ms"] / t_iters
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
