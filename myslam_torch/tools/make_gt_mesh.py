#!/usr/bin/env python
"""Ground-truth mesh generator for the procedural synthetic scene.

The port of ``myslam_tpu/tools/make_gt_mesh.py``.  Real datasets ship GT
meshes for reconstruction evaluation (reference README.md:99-118); the
synthetic scene has an analytic SDF, so its GT mesh is generated
exactly (marching on ``--device``, default the GPU).  The output feeds
the standard protocol:

    python -m myslam_torch.tools.make_gt_mesh configs/Synthetic/room.yaml \
        --output gt.ply [--resolution 0.01] [--cull]
    python -m myslam_torch.tools.cull_mesh <cfg> --input_mesh gt.ply
    python -m myslam_torch.tools.eval_recon --rec_mesh R \
        --gt_mesh gt_culled.ply -3d
"""

from __future__ import annotations

import argparse

from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
from myslam_torch.utils.datasets import Prefetcher, Synthetic, get_dataset


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config", type=str)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--resolution", type=float, default=0.01)
    parser.add_argument("--cull", action="store_true",
                        help="also write the frustum-culled GT mesh "
                             "(GT poses, all frames)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, DEFAULT_CONFIG)
    dataset = get_dataset(cfg)
    if not isinstance(dataset, Synthetic):
        raise SystemExit("GT meshes can only be generated for synthetic "
                         "scenes")
    path = dataset.save_gt_mesh(args.output, resolution=args.resolution,
                                device=args.device)
    print(f"GT mesh written to {path}")
    if args.cull:
        from myslam_torch.tools.cull_mesh import cull_mesh

        frames = ((d, p) for _, (c, d, p) in
                  Prefetcher(dataset, range(len(dataset))))
        out = cull_mesh(path, cfg, frames, device=args.device)
        print(f"Culled GT mesh written to {out}")


if __name__ == "__main__":
    main()
