#!/usr/bin/env python
"""Microbenchmarks of the render path's stages, one at a time.

    python -m myslam_torch.tools.microbench [--config PATH]
        [--n-rays 4000] [--samples 40] [--iters 20] [--device cpu]
        [--json]

The counterpart of ``myslam_tpu/tools/microbench.py``, with the same
stages on the config's layouts (``configs/Synthetic/room.yaml``'s by
default): packing each quad atlas, the tri-plane sample forward, sample
and SDF decode, the gradient of that with respect to the atlas and to
the coordinates, and ``render_rays`` forward and with its gradient,
without and with the importance branch.  Milliseconds per call by CUDA
events over ``--iters`` calls after a synchronize (the host clock with
``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(
        REPO, "configs", "Synthetic", "room.yaml"))
    ap.add_argument("--n-rays", type=int, default=4000)
    ap.add_argument("--samples", type=int, default=40)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' to rehearse")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from myslam_torch import resolve_device
    from myslam_torch.core.sampling import TorchDraws
    from myslam_torch.models.config import get_model
    from myslam_torch.models.decoders import decode_sdf_corners
    from myslam_torch.models.planes import init_map_state
    from myslam_torch.ops.plane_sample import pack_quad, sample_fused
    from myslam_torch.render.renderer import _row_map, render_rays, \
        scene_from_cfg
    from myslam_torch.tools.devtime import time_ms
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    dev = resolve_device(args.device)
    cfg = load_config(args.config, DEFAULT_CONFIG)
    scene = scene_from_cfg(cfg)
    sl, cl = scene.sdf_layout, scene.color_layout
    gen = torch.Generator().manual_seed(0)
    ms = init_map_state(gen, sl, cl, get_model(cfg, gen), device=dev)
    dec = ms.decoder
    n = args.n_rays * args.samples
    tgen = torch.Generator(device=dev).manual_seed(0)
    p_nor = torch.rand((n, 3), generator=tgen, device=dev) * 2.0 - 1.0
    rm = _row_map(sl, dev)
    atlas = ms.sdf_atlas
    quad = pack_quad(atlas.detach(), sl)

    def grad_atlas():
        out = decode_sdf_corners(dec, sample_fused(pack_quad(atlas, sl), sl,
                                                   p_nor), rm)
        return torch.autograd.grad(out.sum(), [atlas])

    p_req = p_nor.clone().requires_grad_()

    def grad_coords():
        out = decode_sdf_corners(dec, sample_fused(quad, sl, p_req), rm)
        return torch.autograd.grad(out.sum(), [p_req])

    rays_o = scene.bound_tensor(dev).mean(dim=1).expand(args.n_rays, 3)
    rays_d = torch.randn((args.n_rays, 3), generator=tgen, device=dev)
    rays_d = rays_d / rays_d.norm(dim=-1, keepdim=True)
    gt_depth = torch.full((args.n_rays,), 1.5, device=dev)
    draws = TorchDraws(0, dev)

    def render(imp):
        @torch.no_grad()
        def fwd():
            return render_rays(draws, ms, scene, rays_o, rays_d, gt_depth,
                               imp)

        def grad():
            d, c, s, _ = render_rays(draws, ms, scene, rays_o, rays_d,
                                     gt_depth, imp)
            return torch.autograd.grad(d.sum() + c.sum() + s.sum(),
                                       [ms.sdf_atlas, ms.color_atlas])
        return fwd, grad

    no_grad = torch.no_grad()
    stages = {
        "pack_quad_sdf": no_grad(lambda: pack_quad(atlas, sl)),
        "pack_quad_color": no_grad(lambda: pack_quad(ms.color_atlas, cl)),
        "sample_fwd": no_grad(lambda: sample_fused(quad, sl, p_nor)),
        "sample_decode_fwd": no_grad(lambda: decode_sdf_corners(
            dec, sample_fused(quad, sl, p_nor), rm)),
        "grad_atlas": grad_atlas,
        "grad_coords": grad_coords,
    }
    for imp in (False, True):
        fwd, grad = render(imp)
        stages[f"render_rays_fwd_imp{int(imp)}"] = fwd
        stages[f"render_rays_grad_imp{int(imp)}"] = grad
    report = {"device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "config": args.config, "points": n,
              "sdf_rows": sl.total_rows, "color_rows": cl.total_rows,
              "iters": args.iters, "ms": {}}
    for name, fn in stages.items():
        report["ms"][name] = time_ms(fn, dev, args.iters)
        if not args.json:
            print(f"{name}: {report['ms'][name]:8.3f} ms", flush=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
