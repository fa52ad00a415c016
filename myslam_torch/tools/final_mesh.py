#!/usr/bin/env python
"""Offline mesh extraction from a checkpoint.

The port of ``myslam_tpu/tools/final_mesh.py``: resumes the newest
checkpoint under ``<output>/ckpts`` and runs the final mesh extraction
and culling exactly as ``SLAMSystem.finalize`` would
(``_extract_and_cull_mesh``), on ``--device`` (default: the GPU) — re-mesh
any finished or interrupted run without re-tracking.

CLI: python -m myslam_torch.tools.final_mesh <config.yaml> [--output DIR]
     [--input_folder DIR]
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config", type=str)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--input_folder", type=str, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args(argv)

    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    cfg = load_config(args.config, DEFAULT_CONFIG)
    slam = SLAMSystem(cfg, input_folder=args.input_folder,
                      output=args.output, device=args.device)
    if slam.resume() == 0:
        raise SystemExit("no checkpoint to mesh from")
    t0 = time.perf_counter()
    out = slam._extract_and_cull_mesh(
        os.path.join(slam.output, "mesh", slam.mesh_name), upto=slam.n_img)
    print(f"Final mesh written to {out} "
          f"({time.perf_counter() - t0:.1f} s)")
    return out


if __name__ == "__main__":
    main()
