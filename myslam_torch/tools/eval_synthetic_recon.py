#!/usr/bin/env python
"""One-command reconstruction eval against the analytic GT (synthetic).

The port of ``myslam_tpu/tools/eval_synthetic_recon.py``: generates the
analytic GT mesh for the scene, culls BOTH meshes in the reference's
eval_rec mode (frustum + depth-occlusion — reference
src/tools/cull_mesh.py:97-98, README.md:104-110), and prints the 3-D
metrics (reference src/tools/eval_recon.py protocol).  Marching, culling and the 2-D
metric's rasterizer run on ``--device`` (default: the GPU).

CLI: python -m myslam_torch.tools.eval_synthetic_recon <config.yaml>
         --rec_mesh out/mesh/final_mesh.ply [--n-frames 120]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", type=str)
    ap.add_argument("--rec_mesh", type=str, required=True,
                    help="UNCULLED reconstruction mesh (final_mesh.ply)")
    ap.add_argument("--n-frames", type=int, default=None,
                    help="cull with this many frames (default: config)")
    ap.add_argument("--resolution", type=float, default=0.01,
                    help="GT mesh resolution (m)")
    ap.add_argument("--workdir", type=str, default=None)
    ap.add_argument("-2d", "--metric_2d", action="store_true",
                    help="also run the reference 2-D depth-L1 protocol "
                    "(virtual views rejection-sampled against the "
                    "trajectory-unseen GT point set)")
    ap.add_argument("--n-views", type=int, default=1000,
                    help="2-D protocol view count (reference: 1000)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    import numpy as np

    from myslam_torch.tools.cull_mesh import cull_mesh, vertex_visibility
    from myslam_torch.tools.eval_recon import calc_2d_metric, calc_3d_metric
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
    from myslam_torch.utils.datasets import Prefetcher, Synthetic, \
        get_dataset

    cfg = load_config(args.config, DEFAULT_CONFIG)
    cfg = copy.deepcopy(cfg)
    if args.n_frames:
        cfg["data"]["n_frames"] = args.n_frames
    cfg["meshing"]["eval_rec"] = True

    dataset = get_dataset(cfg)
    if not isinstance(dataset, Synthetic):
        raise SystemExit("analytic GT exists only for synthetic scenes")

    import sys
    import time

    def phase(msg):
        print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
              flush=True)

    wd = args.workdir or tempfile.mkdtemp(prefix="synth_recon_")
    os.makedirs(wd, exist_ok=True)
    phase(f"GT mesh at {args.resolution} m ...")
    gt_path = dataset.save_gt_mesh(
        os.path.join(wd, "gt_mesh.ply"), resolution=args.resolution,
        device=args.device)

    def frames():
        return ((d, p) for _, (c, d, p)
                in Prefetcher(dataset, range(len(dataset))))

    phase(f"culling rec mesh with {len(dataset)} frames ...")
    rec_culled = cull_mesh(args.rec_mesh, cfg, frames(),
                           out_file=os.path.join(wd, "rec_eval_rec.ply"),
                           device=args.device)
    phase("culling GT mesh ...")
    gt_culled = cull_mesh(gt_path, cfg, frames(),
                          out_file=os.path.join(wd, "gt_eval_rec.ply"),
                          device=args.device)
    phase("3-D metrics (KDTree) ...")
    result = calc_3d_metric(rec_culled, gt_culled)
    phase(f"3-D done: {result}")

    if args.metric_2d:
        # The reference ships *_pc_unseen.npy per scene (README.md:
        # 100-103, consumed at eval_recon.py:156-175).  For the synthetic
        # scene we DERIVE it: vertices of the full-resolution analytic GT
        # mesh that no trajectory frame sees (frustum + occlusion — the
        # same visibility the culling computes).
        from myslam_torch.utils.ply import read_ply

        phase("deriving unseen point set (visibility pass) ...")
        gv, _, _ = read_ply(gt_path)
        seen = vertex_visibility(gv, cfg, frames(), device=args.device)
        pc_unseen = np.asarray(gv)[~seen]
        unseen_path = os.path.join(wd, "gt_pc_unseen.npy")
        np.save(unseen_path, pc_unseen)
        result["unseen_points"] = int(len(pc_unseen))
        phase(f"2-D depth-L1 over {args.n_views} views "
              f"({len(pc_unseen)} unseen pts) ...")
        result.update(calc_2d_metric(rec_culled, gt_culled,
                                     n_imgs=args.n_views,
                                     device=args.device))
    out = {"workdir": wd, **result}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
