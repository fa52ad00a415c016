#!/usr/bin/env python
"""Kernels K1 and K3 (the tri-plane sample forward) on the SLAM loop's own
points and on uniform points.

    python -m myslam_torch.tools.bench_sample_fwd [--runs 4,8,16,32] \
        [--cases map_sdf,map_sdf_f32] [--label L]

The loop's points are ``tools/bench_sample_bwd.loop_points`` (frame 0 of
``configs/Synthetic/room.yaml``, ray-major: a ray's samples are
consecutive and share rows); the uniform ones ``uniform_points`` (past
[-1, 1], the border clamp).  For each sample call of the loop (mapping:
SDF at all 40 samples of 4,000 rays, color at 12; tracking: 2,000 rays;
the exact lane's color at all 40 on an f32 quad; and the mapping SDF
sample on an f32 quad, K3's 2-block cluster) K1 and K3 are checked
against the plain version (1e-5 of the largest value) and timed by CUDA
events: ``ms`` over calls captured in a CUDA graph (device time, no host
time between the kernels), ``ms_events`` over calls made one after
another, with the host's enqueue time per call beside it (where the host
time is near the device time, ``ms_events`` measures the host).  One
JSON line per timing, with the (point, plane) row reads one per point
and after the walk's
reuse (``row_updates``), and the bound: the points and the touched rows
read once, the output written once, over 3.35 TB/s.  Then the card's
name and power limit.

``--runs`` times both kernels with each number of points per run (K1's
``FWD_RUN``, K3's ``SMEM_RUN``); ``--cases`` keeps the named cases.
The script uses only wrapper functions that every version of the port
has, so the same file times another checkout's K1 and K3: run it by its
path from that checkout's root with ``PYTHONPATH=.`` (PERF.md's old/new
comparison).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import torch

from myslam_torch.ops import cuda_sample, smem_sample
from myslam_torch.ops.plane_sample import pack_quad
from myslam_torch.tools.bench_sample_bwd import layouts, loop_points, \
    rel_err, row_updates, time_ms, uniform_points
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

CONFIG = "configs/Synthetic/room.yaml"
SEED = 0
HBM_BYTES_PER_S = 3.35e12
# (name, layout, rays, samples kept per ray (0: all), quad dtype).
CASES = (("map_sdf", "sdf", 4000, 0, "bfloat16"),
         ("map_sdf_f32", "sdf", 4000, 0, "float32"),
         ("map_color", "color", 4000, 12, "bfloat16"),
         ("track_sdf", "sdf", 2000, 0, "bfloat16"),
         ("track_color", "color", 2000, 12, "bfloat16"),
         ("exact_color", "color", 4000, 0, "float32"))


def fwd_bound_ms(layout, n: int, elt: int, rows_touched: int) -> float:
    """Bytes once over the memory rate: the points, the rows these points
    touch and the (N, L*4C) f32 output (~4 flops a byte: bytes bound)."""
    C4 = 4 * layout.c_dim
    nbytes = n * 3 * 4 + rows_touched * C4 * elt + n * layout.n_levels \
        * C4 * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds of fn(): ``reps`` calls captured into one
    CUDA graph, replayed ``replays`` times between CUDA events, so that
    no host time falls between the kernels (the small calls' wrappers
    take about as long on the host as their kernels on the card)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # "relaxed": K3's launch sets its kernel's shared-memory attribute and
    # asks for the cluster occupancy, which global capture refuses.
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    return ms


def host_ms(fn, reps: int = 20) -> float:
    """Milliseconds the host takes to enqueue one call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def kernel_lines(build_log: str) -> list[str]:
    """ptxas's register and spill lines of the forward kernels."""
    out, fn = [], None
    for ln in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        elif fn and "plane_sample_fwd" in fn and ("spill" in ln
                                                  or "registers" in ln):
            out.append(f"{fn}: {ln.strip()}")
    return out


def plan() -> dict:
    """This checkout's points per run (None where it has none)."""
    return {"K1_run": getattr(cuda_sample, "FWD_RUN", None),
            "K3_run": getattr(smem_sample, "SMEM_RUN", None)}


def set_plan(run, k3_run=None) -> None:
    """Points per run of K1 and K3 (K3: ``k3_run`` if given); None leaves
    a constant as it is."""
    for mod, key, val in ((cuda_sample, "FWD_RUN", run),
                          (smem_sample, "SMEM_RUN", k3_run or run)):
        if val is not None:
            setattr(mod, key, val)


def kernels(layout, dtype) -> list:
    """(name, wrapper) of K1, and of K3 where its cluster planner takes
    the layout."""
    out = [("K1", cuda_sample.plane_sample_fwd)]
    try:
        smem_sample.coarse_cluster_blocks(layout, dtype)
    except ValueError:
        return out
    return out + [("K3", smem_sample.plane_sample_fwd_smem)]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default="",
                    help="comma-separated points per run to sweep")
    ap.add_argument("--cases", default="",
                    help="comma-separated case names (default: all)")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_sample_fwd: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    cuda_sample.load()
    print(json.dumps({"label": args.label,
                      "build_s": cuda_sample.BUILD_SECONDS,
                      "ptxas": kernel_lines(cuda_sample.BUILD_LOG)}),
          flush=True)
    cfg = load_config(CONFIG, DEFAULT_CONFIG)
    lays = layouts(cfg)
    runs = [int(r) for r in args.runs.split(",") if r] or [None]
    if runs != [None] and not hasattr(cuda_sample, "FWD_RUN"):
        raise SystemExit("this checkout's K1 has no runs to sweep")
    saved = plan()
    wanted = [c for c in args.cases.split(",") if c]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    recs = []
    for name, lay, n_rays, keep, dtype in CASES:
        if wanted and name not in wanted:
            continue
        layout = lays[lay]
        atlas = 0.01 * torch.randn((layout.total_rows, layout.c_dim),
                                   generator=gen, device=dev)
        quad = pack_quad(atlas, layout).to(getattr(torch, dtype)).contiguous()
        rays = loop_points(cfg, n_rays, dev, SEED, keep)
        n = rays.shape[0]
        for order, p_nor in (("rays", rays),
                             ("uniform", uniform_points(n, gen, dev))):
            ref = cuda_sample.plane_sample_fwd_ref(quad, layout, p_nor)
            for run in runs:
                counts = row_updates(layout, p_nor,
                                     run or saved["K1_run"] or 16)
                set_plan(run)
                for kname, fn in kernels(layout, quad.dtype):
                    out = fn(quad, layout, p_nor)
                    torch.cuda.synchronize()
                    rec = {"label": args.label, "kernel": kname,
                           "case": name, "layout": lay,
                           "rows": layout.total_rows, "points": n,
                           "quad_dtype": dtype, "order": order,
                           **{k: v for k, v in plan().items()
                              if k.startswith(kname)},
                           "rel_err": rel_err(out, ref),
                           "ms": graph_ms(lambda: fn(quad, layout, p_nor)),
                           "ms_events": time_ms(lambda: fn(
                               quad, layout, p_nor), reps=50),
                           "host_ms": host_ms(lambda: fn(
                               quad, layout, p_nor)),
                           "row_reads": counts["updates"],
                           "row_reads_after_reuse": counts["merged"],
                           "rows_touched": counts["rows_touched"],
                           "bound_ms": fwd_bound_ms(
                               layout, n, quad.element_size(),
                               counts["rows_touched"])}
                    if kname == "K3":
                        rec.update({k: smem_sample.LAST_LAUNCH.get(k)
                                    for k in ("cluster_blocks",
                                              "grid_blocks")})
                    recs.append(rec)
                    print(json.dumps(rec), flush=True)
            set_plan(saved["K1_run"], saved["K3_run"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output",
          flush=True)
    bad = [r for r in recs if not r["rel_err"] <= 1e-5]
    if bad:
        raise SystemExit(f"K1/K3 off the plain version by more than 1e-5 "
                         f"of the largest value: {bad}")
    return recs


if __name__ == "__main__":
    main()
