#!/usr/bin/env python
"""A/B: the mapping window with float32 against bfloat16 quad reads.

    python -m myslam_torch.tools.bench_map_bf16 [--config PATH]
        [--rounds 5] [--iters 15] [--device cpu] [--json]

The counterpart of ``myslam_tpu/tools/bench_map_bf16.py``:
``mapping.map_bf16`` casts the quads packed per iteration to bfloat16
(the master atlases, Adam and the losses stay float32).  For both color
lanes (top-K from the config, and exact) the 15-iteration window
(``bench_raysweep.build_window``, from ``make_frame_mapper``) is built
with each read precision, warmed once, then timed in interleaved rounds
(f32, bf16, f32, bf16, ...); medians are reported.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

from myslam_torch.tools.bench_raysweep import REPO, build_window


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(
        REPO, "configs", "Synthetic", "room.yaml"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' to rehearse")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from myslam_torch import resolve_device
    from myslam_torch.tools.devtime import sync
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    dev = resolve_device(args.device)
    cfg = load_config(args.config, DEFAULT_CONFIG)
    topk = int(cfg["rendering"].get("color_topk", 12))
    n = args.iters
    results = {}
    for lane, k in (("topk", topk), ("exact", 0)):
        runs = {}
        for name, bf16 in (("f32", False), ("bf16", True)):
            c = copy.deepcopy(cfg)
            c["mapping"]["map_bf16"] = bf16
            c["rendering"]["color_topk"] = k
            runs[name] = build_window(c, dev)
            runs[name](n)  # warm
        sync(dev)
        times = {"f32": [], "bf16": []}
        for _ in range(args.rounds):
            for name in ("f32", "bf16"):
                t0 = time.perf_counter()
                runs[name](n)
                sync(dev)
                times[name].append((time.perf_counter() - t0) * 1e3)
        med = {name: sorted(ts)[len(ts) // 2] for name, ts in times.items()}
        results[lane] = {
            "color_topk": k,
            "f32_ms_per_iter": med["f32"] / n,
            "bf16_ms_per_iter": med["bf16"] / n,
            "speedup": med["f32"] / med["bf16"],
            "all_ms": times,
        }
        if not args.json:
            print(json.dumps({lane: results[lane]}), flush=True)
    out = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "config": args.config, "window_iters": n, "rounds": args.rounds,
           "lanes": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
