#!/usr/bin/env python3
"""Run the PyTorch/CUDA SLAM loop on a config and print its ATE.

    python run_torch.py configs/Synthetic/room.yaml            # on the GPU
    python run_torch.py configs/Synthetic/room_smoke.yaml --device cpu

The run goes on the GPU unless ``--device cpu`` is given; without a GPU
and without that flag it stops with an error.  The last line of the
output is one JSON object with the ATE and the frame count.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    cfg = load_config(args.config, DEFAULT_CONFIG)
    t0 = time.perf_counter()
    slam = SLAMSystem(cfg, seed=args.seed, device=args.device)
    slam.run_loop()
    wall = time.perf_counter() - t0
    ate = slam.ate()
    out = {
        "device": str(slam.device),
        "frames": slam.n_img,
        "ate_rmse_cm": ate["absolute_translational_error.rmse"] * 100.0,
        "wall_s": wall,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
