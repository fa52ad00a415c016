#!/usr/bin/env python
"""Frames/s of ray DP and of the track||map pipeline projected over n
cards, from the port's own measurements.

    python -m myslam_torch.tools.scaling_report --components FILE
        --raysweep FILE (--link-from FILE | --link-gbps X)
        (--metrics FILE | --fixed-ms-per-frame X) [--config PATH]
        [--reference-fps X] [--markdown]

The counterpart of ``myslam_tpu/tools/scaling_report.py``, with its
model (``project_dp``, ``project_pipeline``) and its exact gradient
payload (``atlas_grad_bytes``), and the port's inputs, each measured on
the card and each required (a missing input is an error, never a
default):

  * ``--components``: ``profile_components --json`` -- the mapping
    iteration's loss and gradient (``full_grad`` ms), the dense Adam
    update (``adam`` ms) and the tracking iteration (``track_iter_ms``);
  * ``--raysweep``: ``bench_raysweep --out`` -- each lane's fitted floor
    (the per-iteration ms that does not shrink with the rays; the
    window's time includes Adam, so the Adam ms is taken off it);
  * the link: ``--link-from`` a gang's record with ``world`` and
    ``collectives`` (``multiproc.run_system``; ``chip_smoke.py`` phase
    ``dp``): the gradient all-reduce's bytes over its seconds, as the
    ring of ``world`` ranks moves them (2 (n-1) / n of the payload), or
    ``--link-gbps``;
  * the host's per-frame cost outside tracking and mapping: ``--metrics``
    a run's ``metrics.jsonl`` (frame ms less track and map ms, frames 1
    on), or ``--fixed-ms-per-frame``.

The repository root's ``perf_profile.json`` and ``raysweep.json`` are
the JAX package's TPU records and are refused.  Prints one JSON object
(``--markdown``: its tables).
"""

from __future__ import annotations

import argparse
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# The JAX package's TPU records: no input of the port's projection.
TPU_RECORDS = ("perf_profile.json", "raysweep.json")


def atlas_grad_bytes(cfg: dict) -> int:
    """The ray-DP gradient payload per mapping iteration, as the JAX
    package counts it: float32 gradients of both unpacked atlases plus
    the decoders (the port's flat buffer adds the window poses and
    counts the decoders' output layers exactly: 676 B more at
    ``room.yaml``)."""
    from myslam_torch.models.planes import compute_bound, make_layout

    bound = compute_bound(cfg)
    c = int(cfg["model"]["c_dim"])
    pres, cres = cfg["planes_res"], cfg["c_planes_res"]
    sdf = make_layout(bound, [pres["coarse"], pres["fine"]], c)
    col = make_layout(bound, [cres["coarse"], cres["fine"]], c)
    n_dec = 2 * (64 * 16 + 16 + 16 * 16 + 16) + 2 * (16 + 1) + 16 + 3 + 1
    return 4 * (sdf.total_rows * c + col.total_rows * c + n_dec)


def ring(n: int) -> float:
    """The share of a payload each rank sends in a ring all-reduce."""
    return 2.0 * (n - 1) / n if n > 1 else 0.0


def project_dp(n, map_iter_ms, map_opt_ms, track_iter_ms, grad_bytes,
               map_iters, track_iters, every_frame, link_gbps,
               fixed_ms_per_frame, zero_opt=True, floor_ms=0.0):
    """Frames/s of the every_frame group at n-way ray DP (serial
    track-then-map order): the loss and gradient divide by n above the
    per-card floor, the dense Adam update by n only with ``zero_opt``,
    one ring all-reduce of ``grad_bytes`` per mapping iteration at
    ``link_gbps``, tracking divided by n, and ``fixed_ms_per_frame`` of
    host work per frame."""
    allreduce_ms = ring(n) * grad_bytes / (link_gbps * 1e9) * 1e3
    opt_ms = map_opt_ms / n if zero_opt else map_opt_ms
    compute_ms = floor_ms + max(map_iter_ms - floor_ms, 0.0) / n
    map_ms = map_iters * (compute_ms + opt_ms + allreduce_ms)
    track_ms = every_frame * track_iters * (track_iter_ms / n)
    group_ms = map_ms + track_ms + every_frame * fixed_ms_per_frame
    return every_frame / (group_ms / 1e3)


def project_pipeline(n_track, n_map, map_iter_ms, map_opt_ms,
                     track_iter_ms, grad_bytes, map_iters, track_iters,
                     every_frame, link_gbps, fixed_ms_per_frame,
                     zero_opt=True, floor_ms=0.0):
    """Frames/s with tracking and mapping on disjoint cards
    (``parallel.pipeline``), ray DP inside each: the steady group takes
    max(track group, map step); one map snapshot per group is charged to
    the mapping side."""
    allreduce_ms = ring(n_map) * grad_bytes / (link_gbps * 1e9) * 1e3
    snapshot_ms = grad_bytes / (link_gbps * 1e9) * 1e3
    opt_ms = map_opt_ms / n_map if zero_opt else map_opt_ms
    compute_ms = floor_ms + max(map_iter_ms - floor_ms, 0.0) / n_map
    map_ms = map_iters * (compute_ms + opt_ms + allreduce_ms) + snapshot_ms
    track_ms = every_frame * track_iters * (track_iter_ms / n_track)
    group_ms = max(map_ms, track_ms) + every_frame * fixed_ms_per_frame
    return every_frame / (group_ms / 1e3)


def link_gbps_of(record: dict, kind: str = "grad") -> float:
    """The link rate a gang's gradient all-reduces reached: each rank
    sends ring(world) of the payload per call, over the call's seconds."""
    c = record["collectives"][kind]
    return (ring(int(record["world"])) * c["bytes"] / c["calls"]
            / (c["seconds"] / c["calls"]) / 1e9)


def fixed_ms_of(metrics_path: str) -> float:
    """Mean ms per frame outside tracking and mapping (frame ms less
    track and map ms, each the frame's share of its tracked group),
    frames 1 on, of a run's metrics.jsonl."""
    rest = []
    with open(metrics_path) as f:
        for line in f:
            r = json.loads(line)
            if r.get("frame", 0) >= 1 and "frame_ms" in r:
                rest.append(r["frame_ms"] - r.get("track_ms", 0.0)
                            - r.get("map_ms", 0.0))
    if not rest:
        raise SystemExit(f"{metrics_path}: no frame records past frame 0")
    return sum(rest) / len(rest)


def _load(path: str) -> dict:
    if os.path.abspath(path) in [os.path.join(REPO, n)
                                 for n in TPU_RECORDS]:
        raise SystemExit(f"{path} is the JAX package's TPU record; pass "
                         "the port's own measurement")
    with open(path) as f:
        return json.load(f)


def report(cfg: dict, components: dict, sweep: dict, link_gbps: float,
           fixed_ms: float, reference_fps: float | None = None,
           chips=(1, 2, 4, 8), pipelines=((1, 1), (1, 3), (2, 6))) -> dict:
    """The projection from the measured inputs: ray DP with the
    row-sharded and the replicated Adam at each chip count, the
    pipeline splits, and the link's sensitivity at 8 chips (x0.5, x1,
    x2) for each lane of the sweep."""
    comp = components["components"]
    map_iter_ms = float(comp["full_grad"]["ms"])
    map_opt_ms = float(comp["adam"]["ms"])
    track_iter_ms = float(components["track_iter_ms"])
    grad_bytes = atlas_grad_bytes(cfg)
    m, t = cfg["mapping"], cfg["tracking"]
    common = dict(map_iters=int(m["iters"]), track_iters=int(t["iters"]),
                  every_frame=int(m["every_frame"]),
                  fixed_ms_per_frame=fixed_ms)
    lanes = {}
    for name, lane in sweep["lanes"].items():
        # The window's ms includes the Adam update, charged apart here.
        floor = max(float(lane["fit_floor_ms"]) - map_opt_ms, 0.0)

        def dp(n, gbps=link_gbps, zero_opt=True):
            return project_dp(n, map_iter_ms, map_opt_ms, track_iter_ms,
                              grad_bytes, link_gbps=gbps, zero_opt=zero_opt,
                              floor_ms=floor, **common)

        rows = [{"chips": n, "fps": dp(n),
                 "fps_replicated_opt": dp(n, zero_opt=False)}
                for n in chips]
        pipe = [{"track_chips": a, "map_chips": b,
                 "fps": project_pipeline(a, b, map_iter_ms, map_opt_ms,
                                         track_iter_ms, grad_bytes,
                                         link_gbps=link_gbps,
                                         floor_ms=floor, **common)}
                for a, b in pipelines]
        if reference_fps:
            for r in rows + pipe:
                r["vs_reference"] = r["fps"] / reference_fps
        lanes[name] = {
            "floor_ms": floor, "dp_projection": rows,
            "pipeline_projection": pipe,
            "sensitivity_link": [{"link_gbps": link_gbps * k,
                                  "fps_at_8": dp(8, link_gbps * k)}
                                 for k in (0.5, 1.0, 2.0)]}
    return {"inputs": {"map_iter_ms": map_iter_ms, "map_opt_ms": map_opt_ms,
                       "track_iter_ms": track_iter_ms,
                       "link_gbps": link_gbps,
                       "fixed_ms_per_frame": fixed_ms,
                       "device": components.get("device"),
                       "reference_fps": reference_fps},
            "grad_bytes_per_map_iter": grad_bytes, "lanes": lanes}


def markdown(rep: dict) -> str:
    lines = []
    for name, lane in rep["lanes"].items():
        lines += [f"## Ray DP, lane {name} (floor "
                  f"{lane['floor_ms']:.2f} ms/iter)", "",
                  "| chips | fps (row-sharded Adam) | fps (replicated "
                  "Adam) |", "|---|---|---|"]
        lines += [f"| {r['chips']} | {r['fps']:.2f} | "
                  f"{r['fps_replicated_opt']:.2f} |"
                  for r in lane["dp_projection"]]
        lines += ["", "| track chips | map chips | fps |", "|---|---|---|"]
        lines += [f"| {r['track_chips']} | {r['map_chips']} | "
                  f"{r['fps']:.2f} |" for r in lane["pipeline_projection"]]
        lines.append("")
    i = rep["inputs"]
    lines.append(
        f"Inputs: map {i['map_iter_ms']:.3f} ms/iter, Adam "
        f"{i['map_opt_ms']:.3f}, track {i['track_iter_ms']:.3f} ms/iter, "
        f"host {i['fixed_ms_per_frame']:.2f} ms/frame, link "
        f"{i['link_gbps']:.3f} GB/s, payload "
        f"{rep['grad_bytes_per_map_iter']} B/iter ({i['device']}).")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(
        REPO, "configs", "Synthetic", "room.yaml"))
    ap.add_argument("--components", required=True,
                    help="profile_components --json output")
    ap.add_argument("--raysweep", required=True,
                    help="bench_raysweep --out output")
    ap.add_argument("--link-from", default=None,
                    help="a gang's record (world, collectives)")
    ap.add_argument("--link-gbps", type=float, default=None)
    ap.add_argument("--metrics", default=None,
                    help="a run's metrics.jsonl (host ms per frame)")
    ap.add_argument("--fixed-ms-per-frame", type=float, default=None)
    ap.add_argument("--reference-fps", type=float, default=None)
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)

    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    if (args.link_from is None) == (args.link_gbps is None):
        raise SystemExit("give the link as --link-from FILE or --link-gbps")
    if (args.metrics is None) == (args.fixed_ms_per_frame is None):
        raise SystemExit("give the host's ms per frame as --metrics FILE "
                         "or --fixed-ms-per-frame")
    link = (args.link_gbps if args.link_from is None
            else link_gbps_of(_load(args.link_from)))
    fixed = (args.fixed_ms_per_frame if args.metrics is None
             else fixed_ms_of(args.metrics))
    rep = report(load_config(args.config, DEFAULT_CONFIG),
                 _load(args.components), _load(args.raysweep), link, fixed,
                 args.reference_fps)
    print(markdown(rep) if args.markdown else json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
