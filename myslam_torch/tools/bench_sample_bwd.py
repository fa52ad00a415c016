#!/usr/bin/env python
"""Kernel K2 (the tri-plane sample backward) on the SLAM loop's own points.

    python -m myslam_torch.tools.bench_sample_bwd [--runs 8,16,40]

The points are built as the loop builds them, on frame 0 of
``configs/Synthetic/room.yaml``: ``sample_pixels``, ``rays_from_uv``,
``depth_guided_z_vals`` (32 stratified + 8 surface samples, jittered),
``normalize_3d_coordinate``; ray-major, so a ray's samples are
consecutive.  For each sample call of the loop (mapping: SDF at all 40
samples of 4,000 rays, color at 12; tracking: 2,000 rays, frozen quads;
the exact lane's color at all 40) K2 is timed by CUDA events, with and
without the quad gradient, on these points and on as many uniform random
points, after a check against its plain version.  One JSON line per
timing, then the card's name and power limit.

``--runs`` times K2 with each number of points per warp (the wrapper's
``BWD_RUN``).  The script uses only functions that every version of the
port has, so the same file times another checkout's K2: run it from that
checkout's root with ``PYTHONPATH=.`` (PERF.md's old/new comparison).

``--banded 1,2`` times banded K2 instead (the map shards' backward) at
the mapping SDF sample on the loop's ray-ordered points (160,000, bf16
quad), on every band of the SDF atlas split in each number of bands
(one band owns every point), with and without the quad gradient, by
CUDA events and in a CUDA graph, beside the unbanded K2 on the same
points; each record also counts the band's owned (point, level) pairs
and the points with an owned level, and the vector reductions of the
quad gradient that this checkout's walk issues (``row_updates``; for the
unbanded K2 its merged runs).  It prints ptxas's registers, shared
memory and spills of the backward kernels first.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

import torch

from myslam_torch.core.geometry import normalize_3d_coordinate, rays_from_uv
from myslam_torch.core.sampling import TorchDraws, depth_guided_z_vals, \
    sample_pixels
from myslam_torch.models.planes import compute_bound, make_layout
from myslam_torch.ops import cuda_sample
from myslam_torch.ops.plane_sample import pack_quad
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
from myslam_torch.utils.datasets import get_dataset

CONFIG = "configs/Synthetic/room.yaml"
SEED = 0
# (name, layout, rays, samples kept per ray (0: all), quad dtype, whether
# the loop asks for the quad gradient).
CASES = (("map_sdf", "sdf", 4000, 0, "bfloat16", True),
         ("map_color", "color", 4000, 12, "bfloat16", True),
         ("track_sdf", "sdf", 2000, 0, "bfloat16", False),
         ("track_color", "color", 2000, 12, "bfloat16", False),
         ("exact_color", "color", 4000, 0, "float32", True))


def layouts(cfg: dict) -> dict:
    bound = compute_bound(cfg)
    c = int(cfg["model"]["c_dim"])
    p, q = cfg["planes_res"], cfg["c_planes_res"]
    return {"sdf": make_layout(bound, [p["coarse"], p["fine"]], c),
            "color": make_layout(bound, [q["coarse"], q["fine"]], c)}


def loop_points(cfg: dict, n_rays: int, device, seed: int = 0,
                keep: int = 0) -> torch.Tensor:
    """Normalized sample points (n_rays * samples, 3) of frame 0, ray-major,
    as the loop's renderer builds them.  ``keep`` > 0 keeps the ``keep``
    samples per ray nearest the surface, nearest first: the top-K color
    samples, whose rendering weights peak at the surface."""
    dev = torch.device(device)
    cam = cfg["cam"]
    r = cfg["rendering"]
    ds = get_dataset(cfg)
    draws = TorchDraws(seed, dev)
    i, j = sample_pixels(draws, n_rays, 0, cam["H"], 0, cam["W"])
    _, depth = ds.sample_pixels(0, i.cpu().numpy(), j.cpu().numpy())
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    c2w = torch.as_tensor(ds.poses[0], dtype=torch.float32, device=dev)
    rays_o, rays_d = rays_from_uv(i, j, c2w, cam["fx"], cam["fy"],
                                  cam["cx"], cam["cy"])
    z = depth_guided_z_vals(draws, depth, float(cfg["model"]["truncation"]),
                            int(r["n_stratified"]), int(r["n_importance"]),
                            bool(r["perturb"]))
    if keep:
        near = torch.topk(-(z - depth[:, None]).abs(), keep, dim=-1).indices
        z = torch.gather(z, -1, near)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    bound = torch.as_tensor(compute_bound(cfg), device=dev)
    return normalize_3d_coordinate(pts.reshape(-1, 3), bound).contiguous()


def row_updates(layout, p_nor: torch.Tensor, run: int) -> dict:
    """What K2's quad gradient writes for these points in this order:
    (point, plane) row updates one by one, after merging the points of a
    ``run``-point span that share a plane's row with the point before,
    and the distinct rows touched."""
    p = p_nor.detach().float().cpu()
    n = p.shape[0]
    span_start = torch.arange(n) % run == 0
    merged = rows = 0
    for _, _, au, av, H, W, _ in layout.planes():
        cell = cuda_sample.plane_coords(p, au, av, H, W)[0]
        change = torch.ones(n, dtype=torch.bool)
        change[1:] = cell[1:] != cell[:-1]
        merged += int((change | span_start).sum())
        rows += int(torch.unique(cell).numel())
    return {"updates": n * 3 * layout.n_levels, "merged": merged,
            "rows_touched": rows}


def banded_row_updates(band, p_nor: torch.Tensor) -> int:
    """The vector reductions banded K2 issues for these points: per warp
    segment of a block's list (``cuda_sample.band_lists``, split as the
    kernel splits it) and per plane, one where the owned row changes and
    one at the segment's end."""
    p = p_nor.detach().float().cpu()
    points, _, lengths = cuda_sample.band_lists(band, p)
    warps = cuda_sample.BWD_BANDED_WARPS
    order, seg = [], []
    for b, length in enumerate(lengths.tolist()):
        for w in range(warps):
            lo, hi = w * length // warps, (w + 1) * length // warps
            order.append(points[b, lo:hi])
            seg.append(torch.full((hi - lo,), b * warps + w))
    order, seg = torch.cat(order), torch.cat(seg)
    total = 0
    for _, _, au, av, H, W, off, y_lo, bh in band.planes():
        row, owned, *_ = cuda_sample.band_coords(p, au, av, H, W, off, y_lo,
                                                 bh, band.total_rows)
        keep = owned[order]
        r, s = row[order][keep], seg[keep]
        if r.numel():
            total += 1 + int(((r[1:] != r[:-1]) | (s[1:] != s[:-1])).sum())
    return total


def uniform_points(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """Uniform points, past [-1, 1] on purpose (the border clamp)."""
    return (torch.rand((n, 3), generator=gen, device=device) * 2.1
            - 1.05).contiguous()


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Max abs error over max |ref|."""
    err = float((got.float() - ref.float()).abs().max())
    return err / max(float(ref.float().abs().max()), 1e-30)


def ptxas_report(build_log: str, key: str) -> dict:
    """{mangled kernel name: registers, shared memory bytes, spill
    bytes} of the kernels whose name holds ``key``, from ptxas -v."""
    out, fn = {}, None
    for ln in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            continue
        if fn is None or key not in fn:
            continue
        rec = out.setdefault(fn, {})
        if "spill" in ln:
            rec["spill_bytes"] = sum(
                int(b) for b in re.findall(r"(\d+) bytes spill", ln))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            rec["registers"] = int(m.group(1))
            rec["smem"] = int(smem.group(1)) if smem else 0
    return out


def band_quads(layout, atlas: torch.Tensor, n_bands: int, dtype):
    """Each map shard's band layout and halo-packed band quad of the
    atlas, as the map shards pack them (parallel/plane_shard.py)."""
    from myslam_torch.parallel import plane_shard as tps

    ts = tps.ShardedPlaneLayout(layout, n_bands)
    rows = ts.local_rows
    sharded = torch.as_tensor(ts.shard_atlas(atlas.cpu().numpy())).to(
        atlas.device)
    out = []
    for d in range(n_bands):
        last = d == n_bands - 1
        nxt = sharded[(d if last else d + 1) * rows:][:rows]
        quad = tps.pack_local(sharded[d * rows:(d + 1) * rows],
                              tps.first_rows(nxt, ts), ts, last)
        out.append((ts.band(d), quad.to(dtype).contiguous()))
    return ts, out


def band_ownership(band, p_nor: torch.Tensor) -> dict:
    """These points on one band: the distinct band rows the owned points
    touch, the owned (point, plane) pairs, the (point, level) pairs with
    an owned plane (the gbar banded K2 needs) and the points with one
    (those it walks).  By ``cuda_sample.band_coords``, which every
    checkout with bands has."""
    p = p_nor.detach().float().cpu()
    touched = pairs = 0
    levels = torch.zeros((band.n_levels, p.shape[0]), dtype=torch.bool)
    for lvl, _, au, av, H, W, off, y_lo, bh in band.planes():
        row, owned, *_ = cuda_sample.band_coords(p, au, av, H, W, off, y_lo,
                                                 bh, band.total_rows)
        touched += int(torch.unique(row[owned]).numel())
        pairs += int(owned.sum())
        levels[lvl] |= owned
    return {"rows_touched": touched, "owned_point_planes": pairs,
            "owned_point_levels": int(levels.sum()),
            "listed_points": int(levels.any(0).sum())}


def bench_banded(cfg: dict, band_counts: list, dev, gen,
                 label: str) -> list[dict]:
    """Banded K2 on every band of each count, and the unbanded K2, at the
    mapping SDF sample on the loop's points (one JSON line each)."""
    from myslam_torch.tools.bench_sample_fwd import graph_ms

    layout = layouts(cfg)["sdf"]
    C = layout.c_dim
    atlas = 0.01 * torch.randn((layout.total_rows, C), generator=gen,
                               device=dev)
    p_nor = loop_points(cfg, 4000, dev, SEED, 0)
    n = p_nor.shape[0]
    gbar = torch.randn((n, layout.n_levels * 4 * C), generator=gen,
                       device=dev)
    runs = [(None, None, layout, pack_quad(atlas, layout).to(
        torch.bfloat16).contiguous())]
    for nb in band_counts:
        runs += [(nb, d, band, quad) for d, (band, quad) in
                 enumerate(band_quads(layout, atlas, nb, torch.bfloat16)[1])]
    recs = []
    for nb, d, lay, quad in runs:
        if nb is None:
            fn, ref = cuda_sample.plane_sample_bwd, \
                cuda_sample.plane_sample_bwd_ref
            own = {"owned_point_levels": n * layout.n_levels,
                   "listed_points": n}
            flushes = row_updates(layout, p_nor, cuda_sample.BWD_RUN)[
                "merged"]
        else:
            fn, ref = cuda_sample.plane_sample_bwd_banded, \
                cuda_sample.plane_sample_bwd_banded_ref
            own = band_ownership(lay, p_nor)
            # This checkout's banded walk (older ones have no lists).
            flushes = (banded_row_updates(lay, p_nor)
                       if hasattr(cuda_sample, "band_lists") else None)
        ref_qg, ref_pg = ref(gbar, quad, lay, p_nor)
        for with_qg in (True, False):
            qg_out, pg_out = fn(gbar, quad, lay, p_nor,
                                need_quad_grad=with_qg)
            torch.cuda.synchronize()
            err = rel_err(pg_out, ref_pg)
            if with_qg:
                err = max(err, rel_err(qg_out, ref_qg))

            def call():
                fn(gbar, quad, lay, p_nor, need_quad_grad=with_qg)

            rec = {"label": label, "case": "map_sdf", "points": n,
                   "bands": nb, "band": d,
                   "owned_point_levels": own["owned_point_levels"],
                   "listed_points": own["listed_points"],
                   "row_updates": flushes,
                   "quad_grad": with_qg,
                   "ms": time_ms(call), "ms_graph": graph_ms(call),
                   "rel_err": err}
            recs.append(rec)
            print(json.dumps(rec), flush=True)
    return recs


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default="",
                    help="comma-separated points per warp to sweep")
    ap.add_argument("--banded", default="",
                    help="comma-separated band counts: time banded K2 "
                         "on each band instead")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_sample_bwd: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    cfg = load_config(CONFIG, DEFAULT_CONFIG)
    lays = layouts(cfg)
    runs = [int(r) for r in args.runs.split(",") if r] or [None]
    if runs != [None] and not hasattr(cuda_sample, "BWD_RUN"):
        raise SystemExit("this checkout's K2 has no run length to sweep")
    default_run = getattr(cuda_sample, "BWD_RUN", None)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    band_counts = [int(b) for b in args.banded.split(",") if b]
    recs = []
    if band_counts:
        cuda_sample.load()
        print(json.dumps({
            "label": args.label, "build_s": cuda_sample.BUILD_SECONDS,
            "ptxas": ptxas_report(cuda_sample.BUILD_LOG, "plane_sample_bwd")}),
            flush=True)
        recs = bench_banded(cfg, band_counts, dev, gen, args.label)
    for name, lay, n_rays, keep, dtype, qg in ([] if band_counts
                                               else CASES):
        layout = lays[lay]
        C = layout.c_dim
        atlas = 0.01 * torch.randn((layout.total_rows, C), generator=gen,
                                   device=dev)
        quad = pack_quad(atlas, layout).to(getattr(torch, dtype)).contiguous()
        rays = loop_points(cfg, n_rays, dev, SEED, keep)
        n = rays.shape[0]
        gbar = torch.randn((n, layout.n_levels * 4 * C), generator=gen,
                           device=dev)
        for order, p_nor in (("rays", rays),
                             ("uniform", uniform_points(n, gen, dev))):
            ref_qg, ref_pg = cuda_sample.plane_sample_bwd_ref(
                gbar, quad, layout, p_nor)
            for run in runs:
                if run is not None:
                    cuda_sample.BWD_RUN = run
                for with_qg in (True, False):
                    qg_out, pg_out = cuda_sample.plane_sample_bwd(
                        gbar, quad, layout, p_nor, need_quad_grad=with_qg)
                    torch.cuda.synchronize()
                    err = rel_err(pg_out, ref_pg)
                    if with_qg:
                        err = max(err, rel_err(qg_out, ref_qg))
                    ms = time_ms(lambda: cuda_sample.plane_sample_bwd(
                        gbar, quad, layout, p_nor, need_quad_grad=with_qg))
                    rec = {"label": args.label, "case": name,
                           "layout": lay, "rows": layout.total_rows,
                           "points": n, "quad_dtype": dtype,
                           "loop_quad_grad": qg, "order": order,
                           "quad_grad": with_qg,
                           "run": run if run is not None else default_run,
                           "ms": ms, "rel_err": err}
                    recs.append(rec)
                    print(json.dumps(rec), flush=True)
            if default_run is not None:
                cuda_sample.BWD_RUN = default_run
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output",
          flush=True)
    bad = [r for r in recs if not r["rel_err"] <= 1e-5]
    if bad:
        raise SystemExit(f"K2 off its plain version by more than 1e-5 of "
                         f"the largest value: {bad}")
    return recs


if __name__ == "__main__":
    main()
