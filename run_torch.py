#!/usr/bin/env python3
"""Run the PyTorch/CUDA SLAM system on a config: the loop, the final
checkpoint and the final mesh; print its ATE.

    python run_torch.py configs/Synthetic/room.yaml            # on the GPU
    python run_torch.py configs/Synthetic/room_smoke.yaml --device cpu

The run goes on the GPU unless ``--device cpu`` is given; without a GPU
and without that flag it stops with an error.  The last line of the
output is one JSON object with the ATE, the frame count and the culled
mesh's path.  A failure of the checkpoint or the mesh raises.
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
    slam.run()
    t_end = time.perf_counter()
    ate = slam.ate()
    out = {
        "device": str(slam.device),
        "frames": slam.n_img,
        "ate_rmse_cm": ate["absolute_translational_error.rmse"] * 100.0,
        "wall_s": slam.drain_wall - t0,
        "final_mesh": slam.final_mesh,
        "finalize_s": t_end - slam.drain_wall,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
