#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--replica-runs N]

Phases, one JSON line each:

  1. build        -- compile the CUDA kernels from myslam_torch/csrc, one
                     nvcc per source, all at once, into one library;
  2. kernels      -- K1 (tri-plane sample forward) and K2 (its backward)
                     against their plain PyTorch versions at the SLAM
                     loop's shapes (mapping: 160,000 SDF and 48,000 color
                     points, f32 and bf16 quads; the exact lane's 160,000
                     color points, f32), on uniform points and on the
                     loop's own ray-ordered points (K2 also on tracking's
                     80,000 frozen-quad points), with the host-counted
                     row reads of K1 and row updates of K2 before and
                     after the walk merges runs, and K3 (the forward with
                     the coarse level in shared memory) against its plain
                     version and K1 at the SDF shape on both point orders
                     (bf16: one block; f32: a 2-block cluster), with their
                     times (``ms``: CUDA events over calls made one after
                     another; ``ms_graph``: over calls captured in a CUDA
                     graph), the plain versions' times, a library
                     yardstick and the bound; and K1 on one chunk of the
                     final SDF volume (420,000 grid-ordered points, bf16
                     quad), the meshing path's call;
  3. slam         -- the SLAM loop: SLAMSystem on configs/Synthetic/room.yaml
                     at full width for 13 frames (frame 0 mapped for 1000
                     iterations, 12 tracked frames, frames 4, 8 and 12
                     mapped), with per-frame times, K1/K2 launch counts,
                     how tracking ran (one CUDA graph capture, then
                     replays) and ATE;
  4. mesh         -- the same SLAMSystem's finalize(): the checkpoint,
                     the final mesh (SDF volume through K1, marching,
                     vertex colors through K1) and its culled copy, with
                     the stage seconds, counts, K1 launches against the
                     expected count and peak memory; K1 on the first
                     chunk of vertex colors against its plain version,
                     and those vertices' uint8 colors in the mesh file
                     against the plain version's; then the analytic GT
                     mesh at 1 cm, both meshes culled in eval_rec mode
                     with the 13 frames, and the 3-D metrics (accuracy
                     must stay under 2 cm); then ``replay``:
                     visualizer_torch.replay of that run with the depth
                     rasterizer on the card (every 4th frame, decoded at
                     600x600), each culled mesh's background equal,
                     element for element, to the CPU rasterizer's;
  5. bench_scatter -- K3's path: tools/bench_scatter.py's gather and
                     scatter sections at Replica room0 scale, one line per
                     strategy; K3 must agree with K1 and its plain version
                     on both room0 atlases and run in clusters of at
                     least 3 blocks;
  6. bench_exact  -- bench_torch.py's exact lane on room.yaml at full
                     width, cut to 13 frames (5 warmup): fps, ATE, K1/K2
                     launches, and its final checkpoint loaded back into a
                     fresh SLAMSystem bit for bit;
  7. slam_packed  -- the packed keyframe store (u8 color, u16 depth and a
                     scale per slot on the card) on
                     configs/Synthetic/room_tum_schedule.yaml as committed
                     (keyframe_device: cpu; 480x640, 5000 pixels, 200
                     tracking and 60 mapping iterations, 48+8 samples,
                     every frame mapped and admitted) cut to 6 frames, so
                     that frame 5 maps with joint poses over 5 keyframes:
                     the store's bytes (exactly half the float16/float32
                     store's at the same capacity) and dtypes, frame times,
                     ATE, K1/K2 launches against the schedule's count, and
                     its checkpoint resumed into a fresh packed SLAMSystem
                     byte for byte;
  8. slam_packed_again -- phase 7's run once more with the same seed:
                     its largest per-frame distance from phase 7 is the
                     card's run-to-run noise (K2's float atomics);
  9. slam_host_staged -- the same run with keyframe_device: host_staged:
                     the same fields, the line cache (lines, misses, slab
                     bytes), one selection fetch per mapped frame, every
                     frame's position within STORE_GATE_M of phase 7's
                     (the two stores make the same draws), beside phase
                     8's noise floor; then finalize(): the checkpoint
                     resumed byte for byte, and the mesh, whose hull comes
                     from the host-side depths, with its stage seconds
                     and K1 launches;
 10. host_evict   -- the host-staged store's line cache under eviction:
                     phase 9's run at 16 frames, a window of 8 keyframes,
                     20 tracking iterations and 200 mapping iterations on
                     frame 0, with the configured cache
                     (a line per slot, never evicts) and the smallest (11
                     lines: admissions evict, later windows upload again);
                     the evicting run must miss, keep every bound line
                     equal to its host slot, and stay within STORE_GATE_M
                     per frame of the other;
 11. codec        -- the port's image codec on this host (utils/imageio.py,
                     csrc/imagecodec.cpp): a full-width 680x1200 render's
                     uint8 RGB and its uint16 depth through PNG byte for
                     byte, and its RGB through the port's JPEG encoder and
                     decoder at quality 95 (4:2:0) within the error that
                     OpenCV's own q95 round trip costs on the same render
                     (JPEG_Q95_MAX_ERR, JPEG_Q95_MEAN_ERR, measured by
                     tests/test_torch_imageio.py); ms per decode and per
                     encode; whether ``import cv2`` works here, and which
                     of OpenCV, Pillow, torchvision and matplotlib are
                     installed;
 12. replica_layout -- the synthetic room at 680x1200 exported by the
                     port's exporter to the Replica layout (13 frames,
                     depth holes), read back by the Replica reader under
                     configs/Replica/replica.yaml's schedule (2,000 px and
                     8 tracking iterations, 4,000 rays and 15 mapping
                     iterations, 32+8 samples, exact color, eval_rec
                     meshing at 1 cm) with room.yaml's bounds,
                     ckpt_freq 4, mesh_freq 8: one run in this process
                     (the reader's poses against Synthetic's, the
                     importance branch taken, K1/K2 launches, ATE,
                     metrics.jsonl), then ``run_torch.py --supervise``
                     killed at frame 9 (MYSLAM_FAULT_KILL): one restart,
                     resumed from 00008.npz at frame 9, the checkpoints,
                     the periodic and final meshes, every frame once in
                     metrics.jsonl, the heartbeat, eval_ate's CLI against
                     the run's RMSE, and every frame within RESUME_GATE_M
                     of the first run (``--replica-runs 2`` makes the
                     uninterrupted run twice and prints their distance,
                     the card's noise that RESUME_GATE_M is set from);
 13. tum_layout   -- the same room exported to the TUM layout at 480x640
                     (6 frames, holes) under configs/TUM_RGBD/tum.yaml's
                     schedule with freiburg1_desk.yaml's crop (384x512,
                     edge 8) and a zero distortion: the rebased first
                     pose, the association, the 368x496 camera, the
                     importance branch, ATE and K1/K2 launches;
 14. vis          -- the in-loop panels: room.yaml at full width for 5
                     frames with tracking panels at iterations 0 and 4 of
                     frames 2 and 4 and mapping panels at iterations 0, 5
                     and 10 of frame 4 (7 panels, each a 1360x3600 JPEG of
                     ground truth, render and residual, through the image
                     renderer: 20 chunks of 40,960 rays, three K1 calls
                     each): the files against the JAX package's gating,
                     each decoded, each panel's mean depth error under 5
                     cm, K1 exactly 60 per panel over the loop's launches,
                     K2 the loop's alone, ATE, seconds per panel; then one
                     panel rendered alone (seconds, peak memory) and K1 at
                     its chunk 10's SDF and color samples (1,638,400
                     ray-ordered points, f32 quads) against its plain
                     version;
 15. components   -- tools/profile_components.py on room.yaml: the
                     mapping iteration by component, ms per call (CUDA
                     events), device ms (torch.profiler) and launches;
 16. raysweep     -- tools/bench_raysweep.py: ms per mapping iteration of
                     the 15-iteration window at 4,000 to 250 rays, the
                     fitted floor and slope.

Phase 2 also holds K1 and K2 at the TUM schedule's shapes (280,000
mapping and tracking points, bf16 quads).  Beside phase 10 runs
``dp_host_staged``: phase 9's run on a gang of 2 ranks (``parallel.devices:
2``), each holding the whole host store and line cache: every rank's
trajectory bit for bit, every frame within STORE_GATE_M of phase 9's,
every rank's bound cache lines equal to their host slots, one selection
fetch per mapped frame, host bytes per rank.  After phase 16,
``scaling``: tools/validate_scaling.py's rows from phases dp and dp_spmd
(bytes per mapping iteration by kind against
``scaling_report.atlas_grad_bytes``: plain DP's all-reduce at 1.00;
ZeRO's reduction the same bytes, its all-gather the atlases' padded
rows), tools/scaling_report.py from phases components and raysweep, the
link rate of phase dp's all-reduces and the host ms per frame of phase
slam's metrics.jsonl, and tools/bench_pose_solver.py on 2 shards at
POSE_SOLVER_BUDGET_S seconds a solver.

Between phases 4 and 5 the gang runs, GANG_RANKS ranks (one process
each, ``myslam_torch/parallel/multiproc.launch``) sharing the card over
gloo, on room.yaml at full width for 13 frames; every rank counts its
K1/K2 launches from zero around its loop, and each phase fails unless
every rank finishes with rank 0's trajectory bit for bit, ATE under
2 cm, K1/K2 launches as its iterations say and one gradient all-reduce
per mapping iteration:

  * K2 without the quad gradient at the reduced pose system's call (one
    pullback of keyframe-sharded BA's Schur system on phase slam's map
    and keyframes, one rank's 2,000 rays) against its plain version;
  * dp            -- ray data parallelism (``parallel.devices: 2``): the
                     backend, per-rank launches, all-reduces per mapped
                     frame, their bytes and mean ms, tracked- and
                     mapped-frame ms beside phase slam's, peak memory;
                     within DP_GATE_M of phase slam's trajectory;
  then side by side (none of their times is a recorded number):
  * kf_schur      -- keyframe-sharded BA (``kf_shards: 2``, ``pose_solver:
                     schur``) on room.yaml's schedule (no joint frame in
                     13: every solve runs with the poses frozen): each
                     rank's keyframe imagery at most half the single-rank
                     store's plus a slot, the pose system's K1/K2
                     launches, and a checkpoint (imagery gathered to rank
                     0) costing the other rank at most a slot of device
                     memory;
  * kf_schur_every -- the same on an every-frame schedule (joint BA from
                     frame 5), where the solve must move the stored
                     keyframes; ATE under KF_SCHUR_EVERY_ATE_CM;
  * dp_again      -- phase dp's run once more (the pair's distance is the
                     gang's spread, within DP_GATE_M);
  * gang_resume   -- ``run_torch.py --launch 2 --supervise`` on phase dp's
                     config with rank 1 killed at frame 9: one restart,
                     both ranks resumed at frame 9, the final trajectory
                     within GANG_RESUME_GATE_M of phase dp's;
  and beside them
  * kf_dp         -- kf_shards x devices on a 2 x 2 grid (4 ranks), frame
                     0 cut to KF_DP_ITERS_FIRST iterations: every rank's
                     trajectory bit for bit, one gradient all-reduce per
                     iteration, the imagery per rank;
  * dp_spmd       -- ray DP under ``dp_impl: spmd`` with ``zero_opt`` (the
                     draws one device makes, Adam's atlas moments
                     row-sharded): every rank's trajectory and map bit for
                     bit, within DP_GATE_M of phase slam's trajectory, the
                     collectives by kind (per mapping iteration one
                     ``grad_rs``, the reduce-scatter of the atlas rows, one
                     ``grad`` of the decoders and poses and one
                     ``zero_gather``, with their bytes), each rank's Adam
                     moments against the
                     replicated Adam's (half, to a row), K1/K2 launches;
  then, each alone:
  * pipeline      -- the track||map pipeline (``parallel.pipeline``: rank 0
                     tracks, rank 1 maps): every frame within
                     PIPELINE_GATE_M of phase slam's, every boundary's
                     snapshot the map of the boundary before (sha256 as
                     sent and as taken); the snapshot's bytes and ms,
                     each role's frame ms, the steady group walls beside
                     phase slam's;
  * map_shards    -- banded map shards (``parallel.map_shards: 2``) cut to
                     MAP_SHARDS_FRAMES frames and MAP_SHARDS_ITERS_FIRST
                     frame-0 iterations: the banded K1/K2 launches, every
                     rank's replicated map bit for bit, within
                     MAP_SHARDS_GATE_M of one rank's run of the same cut
                     schedule, made twice (the pair within it too); each
                     rank's atlas and Adam bytes, the features
                     all-reduce's bytes and ms per sample call;
  * bigstep       -- ``multiproc.run_bigstep`` (2 ranks, ray DP and then
                     keyframe-sharded BA): three 15-iteration chunks each
                     at the Replica operating point, seconds per chunk
                     and peak RSS per rank.
Phase kernels also holds the banded K1/K2 (a map shard's sample) against
their plain banded versions on both bands of the mapping SDF sample
(160,000 ray-ordered points, 12,219-row bf16 quad), their sum over the
bands against the unbanded plain forward.

The build fails the run if ptxas reports a register spill in K1, K2 or
K3.  Then the card's name and power limit, the kernels line (K1's, K2's
and K3's times at the mapping SDF sample on uniform points, and as
``ms_rays`` on the loop's ray-ordered points, each also as
``ms_graph`` / ``ms_rays_graph``; K1's at the volume chunk as
``ms_mesh`` / ``ms_mesh_graph`` and at the vertex-color chunk as
``ms_mesh_colors`` / ``ms_mesh_colors_graph``; K1's and K2's at the TUM
schedule's mapping SDF sample as ``ms_tum*``, with their launches in
phases 7, 9 and 10 as ``launches_slam_packed`` / ``_host_staged`` /
``launches_host_evict``, and in phases 12 and 13 as
``launches_replica_layout`` / ``launches_tum_layout``; K1's at the
image renderer's chunk as ``ms_image`` / ``ms_image_graph`` with its
bound, plain and library times, and K1's and K2's launches in phase 14
as ``launches_vis``; K1's and K2's launches per rank in the gang's
phases as ``launches_dp``, ``launches_kf_schur`` (the pose system's
alone as ``launches_kf_schur_pose_system``), ``launches_gang_resume``,
``launches_pipeline``, ``launches_map_shards``, ``launches_kf_dp``,
``launches_dp_spmd`` and ``launches_dp_host_staged``,
and K2's at the Schur pullback as ``ms_schur_p_grad_only`` with its
bound; the banded K1 / K2 as kernels of their own, band 0's times and
both bands' as ``ms_bands``, their launches in phase map_shards), and
last
``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero without that last line; so does a machine without
a GPU.  There is no CPU path.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

N_FRAMES = 13
SEED = 0
DEVICE = "cuda"
# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Launch counts of the SLAM loop: per tracking and per mapping iteration,
# one SDF sample and one color sample, each differentiated once, by K1
# and K2.  K3 is not on that path (bench_scatter drives it).
SAMPLES_PER_ITER = 2
SLAM_KERNELS = ("plane_sample_fwd", "plane_sample_bwd")
# The samples the kernels phase checks, (layout, rays, samples kept per
# ray (0: all 40), quad dtypes): the mapping samples of the top-K lane
# (SDF at all 40 samples of 4,000 rays, 160,000 points; color at the
# top 12, 48,000) and the exact lane's color sample at all 40 (f32 quad:
# map_bf16 is off there).  Each on uniform points and on the loop's own
# ray-ordered points of frame 0 (tools/bench_sample_bwd.loop_points).
KERNEL_CASES = (("sdf", 4000, 0, ("float32", "bfloat16")),
                ("color", 4000, 12, ("float32", "bfloat16")),
                ("color", 4000, 0, ("float32",)))
# Tracking's SDF sample (2,000 rays, 80,000 points, frozen bf16 quad):
# K2 without the quad gradient, on the loop's points.
TRACK_CASE = ("sdf", 2000, 0, ("bfloat16",))
# bench_scatter at room0 scale: points and timed repetitions.
BENCH_POINTS = 160_000
BENCH_ITERS = 10
EXACT_WARMUP = 5
# Phases 7-10: the TUM schedule's config and its cut.
TUM_CONFIG = "configs/Synthetic/room_tum_schedule.yaml"
STORE_FRAMES = 6
# Largest per-frame distance between two runs of one seed that differ
# only in where the keyframe imagery lives: about 3x the card's
# run-to-run noise, which phase 8 measures and prints (PERF.md: 0.28 to
# 1.52 mm between two packed runs).
STORE_GATE_M = 0.005
# Phase 10's cut: a window of 8 keyframes (w_max 10, so the smallest cache
# has 11 lines) and 16 frames, so that frames 11-15 admit past the lines
# (the committed window of 20 needs 28 frames for the same eviction), 20
# tracking iterations per frame (the store sees none of them) and 200
# mapping iterations on frame 0 (whose window holds one keyframe).
EVICT_WINDOW = 8
EVICT_FRAMES = 16
EVICT_TRACK_ITERS = 20
EVICT_ITERS_FIRST = 200
# The TUM schedule's samples (5,000 rays at all 48+8 samples, bf16 quads;
# color_topk 0): mapping's SDF and color samples, and tracking's.
TUM_CASES = (("sdf", 5000, 0, ("bfloat16",)),
             ("color", 5000, 0, ("bfloat16",)))
TUM_TRACK_CASE = ("sdf", 5000, 0, ("bfloat16",))
# The analytic GT mesh's resolution (meters) in phase mesh.
GT_RESOLUTION = 0.01
# Phase codec: what OpenCV's own JPEG round trip at quality 95 (4:2:0)
# costs on frame 0 of room.yaml at 680x1200, largest and mean absolute
# error in uint8 levels (tests/test_torch_imageio.py measures it).
JPEG_Q95_MAX_ERR = 4
JPEG_Q95_MEAN_ERR = 0.4652
CODEC_REPS = 10
# Phases 12 and 13: the scene exported (its camera and bounds), the
# configs the runs inherit, and the cuts.
REPLICA_SOURCE = "configs/Synthetic/room.yaml"
REPLICA_CONFIG = "configs/Replica/replica.yaml"
REPLICA_FRAMES = 13
# MYSLAM_FAULT_KILL's frame: the run dies at frame 9's start, after the
# checkpoint of frame 8 (ckpt_freq 4).
KILL_FRAME = 9
# Largest per-frame distance between the supervised (killed and resumed)
# run and the uninterrupted one: 3x the distance between two
# uninterrupted runs of one seed on the card (14.5 mm, PERF.md: K2's float
# atomics, which the loose 8-iteration tracking of this schedule carries
# from frame to frame; the resumed float store also restores its depths
# only to half a quantization step).
RESUME_GATE_M = 0.045
TUM_LAYOUT_CONFIG = "configs/TUM_RGBD/tum.yaml"
TUM_CROP_CONFIG = "configs/TUM_RGBD/freiburg1_desk.yaml"
TUM_LAYOUT_FRAMES = 6
# Phase vis: room.yaml at full width, cut to VIS_FRAMES, with panels of
# tracking (every 2nd frame, iterations 0 and 4 of 8) and mapping (every
# 4th mapped frame but frame 0, iterations 0, 5 and 10 of 15); the image
# renderer's chunk (make_image_renderer's ray_batch_size); the gate on a
# panel's mean |rendered - input| depth over the pixels with depth.
VIS_FRAMES = 5
VIS_SETTINGS = {"tracking": {"vis_freq": 2, "vis_inside_freq": 4},
                "mapping": {"vis_freq": 4, "vis_inside_freq": 5}}
IMAGE_CHUNK = 40960
VIS_DEPTH_GATE_M = 0.05
# Phase replay: every 4th frame of the phase-slam run; a broken camera
# or mesh covers nothing of the frame (the 13-frame run's culled mesh
# covers 5.4 % under the replay's fixed framing, NVIDIA H100 80GB HBM3).
REPLAY_EVERY = 4
REPLAY_MIN_COVER = 0.01
# The chunk of a panel whose two fine samples phase vis holds K1 at.
IMAGE_CHUNK_INDEX = 10
# Phases components and raysweep: the calls per component, the windows
# per ray count.
COMPONENT_ITERS = 10
RAYSWEEP_REPS = 2
# The gang (phases dp, dp_again, kf_schur, gang_resume): GANG_CONFIG
# (room.yaml) at full width over GANG_RANKS ranks, one process each,
# sharing the card; phase scaling reads its payload from GANG_CONFIG too.
GANG_CONFIG = "configs/Synthetic/room.yaml"
GANG_RANKS = 2
GANG_KILL = f"{KILL_FRAME}:1"  # rank 1 dies at frame 9
# Gates from the gang's own spread on the card, 3x the largest per-frame
# distance measured between phases dp and dp_again, two uninterrupted
# runs of one seed (3.0-6.2 mm over four runs, PERF.md): the ray-DP run's
# distance from phase slam's single-rank run (its renderer jitter is drawn
# at the local batch's shape, as JAX's is: another realization), the pair's
# own, and the supervised gang's from the uninterrupted one.
DP_GATE_M = 0.0186
GANG_RESUME_GATE_M = 0.0186
# Phase kf_schur_every: kf_schur on an every-frame schedule, so that joint
# BA turns on at frame 5 and the reduced (Schur) solve moves the window's
# poses in frames 5-12.  Its ATE gate: the reference's solve drifts the
# window's poses (2.0-2.2 cm from 0.7 cm in three frames at 48x64, the port
# within 1e-6 of it: tests/test_torch_parallel_schur.py), and the card read
# 1.911 and 2.438 cm (PERF.md), so the other phases' 2 cm does not hold the
# method; a broken solve leaves the room (15-20 cm a solve at 24x32).
KF_SCHUR_EVERY = {"every_frame": 1, "keyframe_every": 1}
KF_SCHUR_EVERY_ATE_CM = 4.0
# The least that phase kf_schur_every's mapping must move a stored
# keyframe in some frame: the solve moved the poses.
BA_MOVE_MIN_M = 1e-4
# Phase pipeline: the JAX package's gate of the pipeline's trajectory
# against the serial run's, per frame (tests/test_pipeline.py:54-59).
PIPELINE_GATE_M = 0.02
# Phase map_shards: room.yaml at full width cut in depth (each mapping
# iteration all-reduces the (N, 256) float32 features of every sample
# call, ~213 MB, through the host): 5 frames, 100 frame-0 iterations.
MAP_SHARDS_FRAMES = 5
MAP_SHARDS_ITERS_FIRST = 100
# Its gate: 3x the largest per-frame distance between two one-rank runs
# of that schedule on the card (K2's atomics): 0.0458 mm over 32 pairs,
# the gang 0.014-0.057 mm from one rank (PERF.md).
MAP_SHARDS_GATE_M = 1.37e-4
# Phase kf_dp: kf_shards x devices on a K x D grid of ranks, its frame 0
# cut to 200 iterations for the script's time (beside four other gangs
# frame 0's 1,000 took 146 s on an H100, PERF.md).
KF_DP_GRID = (2, 2)
KF_DP_ITERS_FIRST = 200
# Phase bigstep: mapping chunks of run_bigstep over GANG_RANKS ranks.
BIGSTEP_CHUNKS = 3
# Phase dp_spmd: ray DP that draws what one device draws, with the
# row-sharded Adam (the JAX package's zero_opt default).
DP_SPMD = {"devices": GANG_RANKS, "dp_impl": "spmd", "zero_opt": True}
# Phase scaling: the seconds each pose solver gets.
POSE_SOLVER_BUDGET_S = 2.0
# The mapping collectives validate_scaling reads.
MAP_KINDS = ("grad", "grad_rs", "zero_gather", "loss")
EMIT_LOCK = threading.Lock()


def emit(obj) -> None:
    line = json.dumps(obj)
    with EMIT_LOCK:  # phases that run side by side print whole lines
        print(line, flush=True)


class Background:
    """``fn(*args)`` in a thread; ``join()`` returns its result or raises
    what it raised."""

    def __init__(self, fn, *args):
        self._out: dict = {}

        def run():
            try:
                self._out["value"] = fn(*args)
            except BaseException as e:  # raised again by join()
                self._out["error"] = e

        self._thread = threading.Thread(target=run)
        self._thread.start()

    def wait(self) -> None:
        """Wait for ``fn`` to end, whatever it returned or raised."""
        self._thread.join()

    def join(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch

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


def kernel_times(fn) -> dict:
    """Mean milliseconds of a kernel's wrapper two ways: ``ms`` by CUDA
    events over calls made one after another (time_ms, the method of the
    earlier runs; where the host enqueues a call more slowly than the card
    runs it, it measures the host), and ``ms_graph`` over calls captured
    in a CUDA graph (tools/bench_sample_fwd.graph_ms: no host time between
    the kernels)."""
    from myslam_torch.tools.bench_sample_fwd import graph_ms

    return {"ms": time_ms(fn), "ms_graph": graph_ms(fn)}


def scaled_err(got, ref) -> tuple[float, float]:
    """(max abs error, max abs error over max |ref|)."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-30)


def grid_sample_features(planes, layout, p_nor):
    """The library yardstick: the reduced features (N, L*C) by six
    F.grid_sample calls (bilinear, border, align_corners=True) and the
    orientation sum.  The port never calls this."""
    import torch
    import torch.nn.functional as F

    from myslam_torch.models.planes import ORIENTATIONS

    feats = []
    for lvl in range(layout.n_levels):
        acc = 0
        for ori, (au, av) in enumerate(ORIENTATIONS):
            grid = p_nor[:, [au, av]][None, :, None, :]
            acc = acc + F.grid_sample(
                planes[lvl * 3 + ori], grid, mode="bilinear",
                padding_mode="border", align_corners=True)[0, :, :, 0].t()
        feats.append(acc)
    return torch.cat(feats, dim=-1)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for the work on the card, and what sets it."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_FLOPS * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def bwd_bound(n: int, layout, elt: int, rows: dict,
              quad_grad: bool) -> tuple[float, str, int]:
    """K2's bound on these points: gbar, the coordinates and p_grad once,
    the touched quad rows once, and with the quad gradient its touched
    rows written once; 7 (5 without the quad gradient) f32 operations per
    (point, plane, lane)."""
    C4, L = 4 * layout.c_dim, layout.n_levels
    nbytes = n * L * C4 * 4 + 2 * n * 3 * 4 + rows["rows_touched"] * C4 * (
        elt + (4 if quad_grad else 0))
    ms, by = bound_ms(nbytes, (7 if quad_grad else 5) * n * 3 * L * C4)
    return ms, by, nbytes


def check_bwd(gbar, quad, layout, p_nor, rows, planes) -> dict:
    """K2, with and without the quad gradient, against its plain version
    on these points; its times, the plain version's, the library's
    (grid_sample's backward, and with the planes frozen) and the bounds."""
    import torch

    from myslam_torch.ops import cuda_sample

    qg, pg = cuda_sample.plane_sample_bwd(gbar, quad, layout, p_nor)
    _, pg_only = cuda_sample.plane_sample_bwd(gbar, quad, layout, p_nor,
                                              need_quad_grad=False)
    rqg, rpg = cuda_sample.plane_sample_bwd_ref(gbar, quad, layout, p_nor)
    torch.cuda.synchronize()
    q_err, q_rel = scaled_err(qg, rqg)
    p_err, p_rel = scaled_err(pg, rpg)
    po_err, po_rel = scaled_err(pg_only, rpg)
    # Tolerance: the same float32 products summed in another order (FMA
    # contraction; runs merged in registers, then vector atomics, against
    # index_add_; a warp butterfly against torch.sum): 1e-5 of the
    # largest value.
    for what, rel in (("quad_grad", q_rel), ("p_grad", p_rel),
                      ("p_grad without quad_grad", po_rel)):
        if not rel <= 1e-5:
            raise AssertionError(
                f"K2 {layout.total_rows} rows {quad.dtype} {what}: error "
                f"{rel:.3e} of the largest value exceeds 1e-5")
    # Points outside the bound on every axis get no coordinate gradient
    # from the clamped planes.
    out_all = (p_nor.abs() > 1.0).all(dim=1)
    for got in (pg, pg_only):
        if bool(out_all.any()) and float(got[out_all].abs().max()) != 0:
            raise AssertionError("K2: p_grad outside the border")

    grid_in = p_nor.clone().requires_grad_()
    lib_out = grid_sample_features(planes, layout, grid_in)
    lib_gbar = torch.randn_like(lib_out)
    grid_fz = p_nor.clone().requires_grad_()
    lib_out_fz = grid_sample_features([q.detach() for q in planes], layout,
                                      grid_fz)
    n, elt = p_nor.shape[0], quad.element_size()
    bb, bby, nbytes = bwd_bound(n, layout, elt, rows, True)
    pb, pby, p_bytes = bwd_bound(n, layout, elt, rows, False)
    return {
        "max_abs_err": max(q_err, p_err, po_err), "quad_grad_err": q_err,
        "p_grad_err": p_err, "p_grad_only_err": po_err,
        **kernel_times(lambda: cuda_sample.plane_sample_bwd(
            gbar, quad, layout, p_nor)),
        "ms_p_grad_only": time_ms(lambda: cuda_sample.plane_sample_bwd(
            gbar, quad, layout, p_nor, need_quad_grad=False)),
        "plain_ms": time_ms(lambda: cuda_sample.plane_sample_bwd_ref(
            gbar, quad, layout, p_nor), reps=5),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            lib_out, planes + [grid_in], lib_gbar, retain_graph=True),
            reps=5),
        "bytes": nbytes, "bound_ms": bb, "bound_by": bby,
        "rows_touched": rows["rows_touched"],
        "p_grad_only": {
            "plain_ms": time_ms(lambda: cuda_sample.plane_sample_bwd_ref(
                gbar, quad, layout, p_nor, need_quad_grad=False), reps=5),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                lib_out_fz, [grid_fz], lib_gbar, retain_graph=True),
                reps=5),
            "bytes": p_bytes, "bound_ms": pb, "bound_by": pby},
    }


def check_fwd(quad, layout, p_nor, rows, planes) -> tuple:
    """K1 against its plain version on these points; its time, the plain
    version's, the library yardstick's and the bound, with the row reads
    before and after the walk's reuse (``rows``: ``row_updates`` at K1's
    run).  Also returns the output and the plain one, for K3."""
    import torch

    from myslam_torch.ops import cuda_sample

    out = cuda_sample.plane_sample_fwd(quad, layout, p_nor)
    ref = cuda_sample.plane_sample_fwd_ref(quad, layout, p_nor)
    torch.cuda.synchronize()
    err, rel = scaled_err(out, ref)
    # Tolerance: the same float32 products, FMA-contracted, summed over
    # the three orientations in the plain version's order: 1e-5 of the
    # largest value.
    if not rel <= 1e-5:
        raise AssertionError(
            f"K1 {layout.total_rows} rows {quad.dtype} forward: error "
            f"{rel:.3e} of the largest value exceeds 1e-5")
    n, C4, L = p_nor.shape[0], 4 * layout.c_dim, layout.n_levels
    # The points, the rows they touch and the f32 output, once each.
    nbytes = (n * 3 * 4 + rows["rows_touched"] * C4 * quad.element_size()
              + n * L * C4 * 4)
    b_ms, b_by = bound_ms(nbytes, 2 * n * 3 * L * C4)
    grid_in = p_nor.clone().requires_grad_()
    return {"max_abs_err": err, **kernel_times(
        lambda: cuda_sample.plane_sample_fwd(quad, layout, p_nor)),
        "plain_ms": time_ms(lambda: cuda_sample.plane_sample_fwd_ref(
            quad, layout, p_nor), reps=5),
        # A yardstick, not the same function: grid_sample gives the
        # reduced (N, L*C) features, a quarter of K1's output.
        "library_ms": time_ms(lambda: grid_sample_features(
            planes, layout, grid_in), reps=5),
        "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
        "row_reads": rows["updates"], "row_reads_after_reuse":
        rows["merged"], "rows_touched": rows["rows_touched"]}, out, ref


def check_kernels(cfg, layouts, cases=KERNEL_CASES,
                  track_cases=(TRACK_CASE,), config=None) -> list[dict]:
    """K1 and K2 (with and without the quad gradient) against their plain
    versions, and K3 against its plain version and K1 on the SDF layout,
    each on uniform points and on the loop's own ray-ordered points; K2
    also on tracking's (``track_cases``).  Returns one record per
    (layout, points, dtype) case."""
    import torch

    from myslam_torch.ops import cuda_sample
    from myslam_torch.ops.plane_sample import pack_quad
    from myslam_torch.tools.bench_sample_bwd import loop_points, \
        row_updates, uniform_points

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    records = []
    for (name, n_rays, keep, dtypes), track in (
            [(c, False) for c in cases] + [(c, True) for c in track_cases]):
        layout = layouts[name]
        C, L = layout.c_dim, layout.n_levels
        rays = loop_points(cfg, n_rays, dev, SEED, keep)
        n = rays.shape[0]
        atlas = 0.01 * torch.randn((layout.total_rows, C), generator=gen,
                                   device=dev)
        # Past [-1, 1] on purpose: the border clamp and its zero
        # coordinate gradient are part of what is checked.
        p_nor = uniform_points(n, gen, dev)
        gbar = torch.randn((n, L * 4 * C), generator=gen, device=dev)
        gbar_rays = torch.randn((n, L * 4 * C), generator=gen, device=dev)
        planes = [atlas[off:off + H * W].reshape(H, W, C).permute(2, 0, 1)
                  [None].contiguous().requires_grad_()
                  for _, _, _, _, H, W, off in layout.planes()]
        rows = {order: row_updates(layout, pts, cuda_sample.BWD_RUN)
                for order, pts in (("uniform", p_nor), ("rays", rays))}
        fwd_rows = {order: row_updates(layout, pts, cuda_sample.FWD_RUN)
                    for order, pts in (("uniform", p_nor), ("rays", rays))}
        emit({"phase": "kernels_rows", "config": config, "layout": name,
              "points": n,
              "run": cuda_sample.BWD_RUN, **rows,
              "fwd_run": cuda_sample.FWD_RUN, "fwd": fwd_rows})
        for dtype in (getattr(torch, d) for d in dtypes):
            quad = pack_quad(atlas, layout).to(dtype).contiguous()
            rec = {"layout": name, "rows": layout.total_rows, "points": n,
                   "quad_dtype": str(dtype).replace("torch.", "")}
            if config:
                rec["config"] = config
            if track:
                # Tracking's sample: frozen quads, K2 without the quad
                # gradient (its record's p_grad_only).
                rec["case"] = "tracking"
                rec["bwd_rays"] = check_bwd(gbar_rays, quad, layout, rays,
                                            rows["rays"], planes)
                records.append(rec)
                emit({"phase": "kernels", **rec})
                continue
            for key, pts in (("fwd", p_nor), ("fwd_rays", rays)):
                rec[key], out, ref = check_fwd(
                    quad, layout, pts, fwd_rows[key[4:] or "uniform"],
                    planes)
                if name == "sdf":
                    rec["smem" + key[3:]] = check_smem(quad, layout, pts,
                                                       ref, out, rec[key])
            del out, ref
            rec["bwd"] = check_bwd(gbar, quad, layout, p_nor,
                                   rows["uniform"], planes)
            rec["bwd_rays"] = check_bwd(gbar_rays, quad, layout, rays,
                                        rows["rays"], planes)
            records.append(rec)
            emit({"phase": "kernels", **rec})
    return records


def check_banded(cfg, layout, unbanded_bwd: dict, n_bands: int = 2) -> dict:
    """Banded K1 and K2 (the map shards' sample) against their plain
    banded versions at the mapping SDF sample on the loop's ray-ordered
    points (160,000), on each of ``n_bands`` bands of the SDF atlas's
    bf16 quad, within 1e-5 of the largest value; the shards' forward
    summed against the unbanded plain forward; ms (events and graph),
    the plain versions' ms and the bounds (the points, the owned rows
    touched and the output once; K2: gbar of the (point, level) pairs
    with an owned plane, the points, p_grad, the owned rows read and
    their gradient written; 2 and 7 f32 operations per owned (point,
    plane, lane)).  Beside them: the points banded K2 walks on each band
    (those with an owned level) and the vector reductions its quad
    gradient issues (``row_updates``), its ms without the quad gradient,
    its ptxas registers, shared memory and spills, and the unbanded K2's
    ms on the same points (``unbanded_bwd``, phase kernels' record)."""
    import torch

    from myslam_torch.ops import cuda_sample
    from myslam_torch.tools.bench_sample_bwd import band_ownership, \
        band_quads, banded_row_updates, loop_points, ptxas_report

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    C, L = layout.c_dim, layout.n_levels
    C4 = 4 * C
    p_nor = loop_points(cfg, KERNEL_CASES[0][1], dev, SEED, 0)
    n = p_nor.shape[0]
    atlas = 0.01 * torch.randn((layout.total_rows, C), generator=gen,
                               device=dev)
    gbar = torch.randn((n, L * C4), generator=gen, device=dev)
    ts, quads = band_quads(layout, atlas, n_bands, torch.bfloat16)
    rows = ts.local_rows
    bands, fwd_sum = [], 0
    for d, (band, quad) in enumerate(quads):
        out = cuda_sample.plane_sample_fwd_banded(quad, band, p_nor)
        ref = cuda_sample.plane_sample_fwd_banded_ref(quad, band, p_nor)
        qg, pg = cuda_sample.plane_sample_bwd_banded(gbar, quad, band, p_nor)
        _, pg_only = cuda_sample.plane_sample_bwd_banded(
            gbar, quad, band, p_nor, need_quad_grad=False)
        rqg, rpg = cuda_sample.plane_sample_bwd_banded_ref(gbar, quad, band,
                                                           p_nor)
        torch.cuda.synchronize()
        errs = {what: scaled_err(got, want) for what, got, want in (
            ("fwd", out, ref), ("quad_grad", qg, rqg), ("p_grad", pg, rpg),
            ("p_grad without quad_grad", pg_only, rpg))}
        # Tolerance: K1's and K2's (the same products, FMA-contracted,
        # summed in another order): 1e-5 of the largest value.
        for what, (_, rel) in errs.items():
            if not rel <= 1e-5:
                raise AssertionError(f"banded {what}, band {d}: error "
                                     f"{rel:.3e} of the largest value")
        fwd_sum = fwd_sum + out
        own = band_ownership(band, p_nor)
        touched, pairs, owned_levels = (own["rows_touched"],
                                        own["owned_point_planes"],
                                        own["owned_point_levels"])
        f_bytes = n * 3 * 4 + touched * C4 * 2 + n * L * C4 * 4
        # K2 needs gbar only where the point owns a plane of the level.
        b_bytes = (owned_levels * C4 * 4 + 2 * n * 3 * 4
                   + touched * C4 * (2 + 4))
        f_ms, f_by = bound_ms(f_bytes, 2 * pairs * C4)
        b_ms, b_by = bound_ms(b_bytes, 7 * pairs * C4)
        bands.append({
            "band": d, "band_rows": rows, **own,
            "row_updates": banded_row_updates(band, p_nor),
            "fwd": {"max_abs_err": errs["fwd"][0], **kernel_times(
                lambda: cuda_sample.plane_sample_fwd_banded(quad, band,
                                                            p_nor)),
                "plain_ms": time_ms(
                    lambda: cuda_sample.plane_sample_fwd_banded_ref(
                        quad, band, p_nor), reps=5),
                "library_ms": None, "bytes": f_bytes, "bound_ms": f_ms,
                "bound_by": f_by},
            "bwd": {"max_abs_err": max(errs["quad_grad"][0],
                                       errs["p_grad"][0]),
                    **kernel_times(lambda: cuda_sample.plane_sample_bwd_banded(
                        gbar, quad, band, p_nor)),
                    "plain_ms": time_ms(
                        lambda: cuda_sample.plane_sample_bwd_banded_ref(
                            gbar, quad, band, p_nor), reps=5),
                    "library_ms": None, "bytes": b_bytes, "bound_ms": b_ms,
                    "bound_by": b_by},
            # Without the quad gradient (no atomics): the same gbar read.
            "bwd_no_quad_grad": {
                "max_abs_err": errs["p_grad without quad_grad"][0],
                **kernel_times(lambda: cuda_sample.plane_sample_bwd_banded(
                    gbar, quad, band, p_nor, need_quad_grad=False))}})
        del out, ref, qg, pg, pg_only, rqg, rpg
    from myslam_torch.ops.plane_sample import pack_quad

    whole = cuda_sample.plane_sample_fwd_ref(
        pack_quad(atlas, layout).to(torch.bfloat16), layout, p_nor)
    _, sum_rel = scaled_err(fwd_sum, whole)
    if not sum_rel <= 1e-5:
        raise AssertionError(f"banded forward summed over the bands: error "
                             f"{sum_rel:.3e} of the largest value")
    out = {"phase": "kernels", "case": "banded", "layout": "sdf",
           "rows": layout.total_rows, "points": n, "bands": n_bands,
           "quad_dtype": "bfloat16", "sum_rel_err": sum_rel,
           "per_band": bands,
           "bwd_ptxas": ptxas_report(cuda_sample.BUILD_LOG,
                                     "plane_sample_bwd_banded"),
           "unbanded_bwd": {k: unbanded_bwd[k] for k in ("ms", "ms_graph")}}
    emit(out)
    return out


def check_mesh_chunk(cfg, layout) -> dict:
    """K1 at the meshing path's call: the middle chunk of the final SDF
    volume (whole x-rows of the grid, z fastest; utils/mesher.py), on a
    bf16 quad of the SDF atlas, as Mesher.eval_sdf_volume makes it."""
    import torch

    from myslam_torch.core.geometry import normalize_3d_coordinate
    from myslam_torch.models.planes import compute_bound
    from myslam_torch.ops import cuda_sample
    from myslam_torch.ops.plane_sample import pack_quad
    from myslam_torch.tools.bench_sample_bwd import row_updates
    from myslam_torch.utils.mesher import Mesher

    dev = torch.device(DEVICE)
    mesher = Mesher(cfg, scene=None, cam=None)
    chunks = mesher.volume_chunks()
    x0, x1 = chunks[len(chunks) // 2]
    bound = torch.as_tensor(compute_bound(cfg), dtype=torch.float32).to(dev)
    p_nor = normalize_3d_coordinate(mesher.chunk_points(x0, x1, dev), bound)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    C = layout.c_dim
    atlas = 0.01 * torch.randn((layout.total_rows, C), generator=gen,
                               device=dev)
    quad = pack_quad(atlas, layout).to(torch.bfloat16).contiguous()
    planes = [atlas[off:off + H * W].reshape(H, W, C).permute(2, 0, 1)
              [None].contiguous() for _, _, _, _, H, W, off in layout.planes()]
    rows = row_updates(layout, p_nor, cuda_sample.FWD_RUN)
    rec, _, _ = check_fwd(quad, layout, p_nor, rows, planes)
    xs, ys, zs = mesher.grid_axes()
    out = {"case": "mesh_volume_chunk", "layout": "sdf",
           "rows": layout.total_rows, "points": p_nor.shape[0],
           "quad_dtype": "bfloat16", "chunk": [x0, x1],
           "chunks": len(chunks), "grid": [len(xs), len(ys), len(zs)],
           "fwd": rec}
    emit({"phase": "kernels", **out})
    return out


def check_color_chunk(slam, verts, colors) -> dict:
    """K1 at the meshing path's other call: the first chunk of vertex
    colors (up to ``color_batch`` vertices of the final mesh, in its
    vertex order) on the bf16 quad of the run's color atlas, as
    Mesher.vertex_colors_u8_device makes it; and the mesh file's uint8
    colors of those vertices against the plain version's, within 1."""
    import numpy as np
    import torch

    from myslam_torch.core.geometry import normalize_3d_coordinate
    from myslam_torch.models.decoders import decode_rgb_corners
    from myslam_torch.ops import cuda_sample
    from myslam_torch.ops.plane_sample import pack_quad
    from myslam_torch.render.renderer import _row_map
    from myslam_torch.tools.bench_sample_bwd import row_updates

    dev = torch.device(DEVICE)
    mesher, scene = slam.mesher, slam.scene
    layout = scene.color_layout
    n = min(len(verts), mesher.color_batch)
    pts = torch.as_tensor(verts[:n] * np.float32(mesher.scale)).to(dev)
    p_nor = normalize_3d_coordinate(pts, scene.bound_tensor(dev))
    atlas = slam.map_state.color_atlas.detach()
    C = layout.c_dim
    quad = pack_quad(atlas, layout).to(torch.bfloat16).contiguous()
    planes = [atlas[off:off + H * W].reshape(H, W, C).permute(2, 0, 1)
              [None].contiguous() for _, _, _, _, H, W, off in layout.planes()]
    rows = row_updates(layout, p_nor, cuda_sample.FWD_RUN)
    rec, _, ref = check_fwd(quad, layout, p_nor, rows, planes)
    with torch.no_grad():
        rgb = decode_rgb_corners(slam.map_state.decoder, ref,
                                 _row_map(layout, dev))
    plain_u8 = torch.clamp(torch.round(rgb * 255.0), 0, 255).to(
        torch.uint8).cpu().numpy()
    color_err = int(np.abs(plain_u8.astype(np.int64)
                           - colors[:n].astype(np.int64)).max())
    # Tolerance: K1's features within 1e-5 of the plain version's can move
    # a color across a rounding boundary, by one step at most.
    if not color_err <= 1:
        raise AssertionError(f"vertex colors differ from the plain "
                             f"version's by {color_err} (limit 1)")
    out = {"case": "mesh_vertex_colors", "layout": "color",
           "rows": layout.total_rows, "points": n, "quad_dtype": "bfloat16",
           "vertices": len(verts), "color_u8_max_err": color_err,
           "fwd": rec}
    emit({"phase": "kernels", **out})
    return out


def check_smem(quad, layout, p_nor, ref, k1_out, k1_rec) -> dict:
    """K3 on the same inputs as K1: against the plain version and K1 (the
    same function, so K1's bound, plain version and yardstick)."""
    import torch

    from myslam_torch.ops import smem_sample

    out = smem_sample.plane_sample_fwd_smem(quad, layout, p_nor)
    torch.cuda.synchronize()
    launch = dict(smem_sample.LAST_LAUNCH)
    err, rel = scaled_err(out, ref)
    _, rel_k1 = scaled_err(out, k1_out)
    # Tolerance: the same float32 products as the plain version and K1,
    # FMA-contracted: 1e-5 of the largest value.
    if not (rel <= 1e-5 and rel_k1 <= 1e-5):
        raise AssertionError(
            f"K3 {quad.dtype}: error {rel:.3e} against the plain version, "
            f"{rel_k1:.3e} against K1, of the largest value; limit 1e-5")
    want = smem_sample.coarse_cluster_blocks(layout, quad.dtype)
    if launch["cluster_blocks"] != want or want != (
            1 if quad.dtype == torch.bfloat16 else 2):
        raise AssertionError(f"K3 {quad.dtype}: cluster {launch}")
    return {"max_abs_err": err, "rel_err_vs_k1": rel_k1, **launch,
            **kernel_times(lambda: smem_sample.plane_sample_fwd_smem(
                quad, layout, p_nor)),
            **{k: k1_rec[k] for k in ("plain_ms", "library_ms", "bytes",
                                      "bound_ms", "bound_by")}}


def sample_calls(slam) -> list[dict]:
    """The samples a finished run made: per mapping iteration an SDF and
    a color sample whose backward makes the quad gradient, per tracking
    iteration both on frozen quads, each launching K1 and K2 once; and
    per mapping iteration of a frame whose window has depth holes the
    importance branch's coarse SDF pass without a gradient (K1 only)."""
    cfg, scene = slam.cfg, slam.scene
    t_iters = int(cfg["tracking"]["iters"])
    tracked = t_iters * sum("track_ms" in r for r in slam.frame_log)
    mapped = sum(r.get("map_iters", 0) for r in slam.frame_log)
    coarse = sum(r["map_iters"] for r in slam.frame_log
                 if r.get("map_importance"))
    k = scene.color_topk if 0 < scene.color_topk < scene.n_samples \
        else scene.n_samples
    calls = []
    for step, launches, quad_grad in (("mapping", mapped, True),
                                      ("tracking", tracked, False)):
        rays = int(cfg[step]["pixels"])
        for layout, per_ray in (("sdf", scene.n_samples), ("color", k)):
            calls.append({"step": step, "layout": layout,
                          "points": rays * per_ray, "quad_grad": quad_grad,
                          "launches": launches, "kernels": SLAM_KERNELS})
    if coarse:
        calls.append({"step": "mapping", "layout": "sdf_coarse",
                      "points": int(cfg["mapping"]["pixels"])
                      * scene.n_stratified, "quad_grad": False,
                      "launches": coarse, "kernels": SLAM_KERNELS[:1]})
    return calls


def expected_launches(slam) -> dict:
    """K1 and K2 launches a finished run must have made (sample_calls)."""
    out = {name: 0 for name in SLAM_KERNELS}
    for c in sample_calls(slam):
        for name in c["kernels"]:
            out[name] += c["launches"]
    return out


def check_launches(launches: dict, expected: dict) -> None:
    """K1 and K2 ran as often as ``expected`` says, K3 never (not on the
    SLAM loop's path)."""
    got = {name: launches[name] for name in SLAM_KERNELS}
    if (got != expected or not all(expected.values())
            or launches["plane_sample_fwd_smem"] != 0):
        raise AssertionError(f"launches {launches}, expected {expected} "
                             "and no K3")


def check_graph_counts(phase: str, counts: dict, iters: int, tracked: int,
                       replayed: bool) -> None:
    """Every tracking iteration ran once, replayed or eagerly
    (``engine/tracker.GRAPH_COUNTS``): where tracking replays (a CUDA
    device, tracking not sharded) one capture, whose frame ran its first
    ``WARMUP_ITERS`` iterations eagerly, and replays for the rest; else
    every iteration eager."""
    from myslam_torch.engine.tracker import WARMUP_ITERS

    total = iters * tracked
    replayed = replayed and total > 0
    warm = min(WARMUP_ITERS, iters) if replayed else total
    want = {"captures": int(replayed), "replays": total - warm,
            "eager_iters": warm}
    if dict(counts) != want:
        raise AssertionError(f"{phase}: tracking ran {counts}, expected "
                             f"{want} for {tracked} frames of {iters} "
                             "iterations")


def map_mode(parallel: str, plan: dict, world: int, host_mode: bool,
             cuda: bool) -> str | None:
    """How a system's mapping iterations run (``engine/mapper.py``):
    "replay" through the frame mapper's captured graph, "eager" without
    a graph (the host-staged store's window mapper and ray DP's sharded
    mappers in the eager loop, map shards' banded backend and the CPU in
    the frame mapper's body run eagerly), or
    None where keyframe-sharded BA maps (its own loop, which
    ``mapper.GRAPH_COUNTS`` does not count)."""
    kf_rows = {"kf": world, "kfdp": plan.get("kf")}.get(parallel, 1)
    if kf_rows and kf_rows > 1:
        return None
    if (not cuda or host_mode or parallel in ("dp", "map")
            or (parallel == "pipeline" and plan["map"] > 1)):
        return "eager"
    return "replay"


def check_map_graph_counts(phase: str, counts: dict, frames: list,
                           mode: str | None) -> None:
    """Every mapping iteration ran once, replayed or eagerly
    (``engine/mapper.GRAPH_COUNTS``).  ``frames``: (iterations,
    importance, panels) of each mapped frame in order; ``mode`` as
    ``map_mode`` says.  Replayed, each of the two mappers (with and
    without the importance branch) captures at its first frame without
    panels that has more than ``WARMUP_ITERS`` iterations, whose first
    ``WARMUP_ITERS`` run eagerly, and replays every later iteration; a
    frame with panels runs eagerly."""
    from myslam_torch.engine.mapper import WARMUP_ITERS

    want = {"captures": 0, "replays": 0, "eager_iters": 0}
    captured = set()
    for iters, importance, panels in frames if mode else ():
        if mode == "eager" or panels:
            want["eager_iters"] += iters
            continue
        done = 0
        if importance not in captured:
            done = min(WARMUP_ITERS, iters)
            want["eager_iters"] += done
            if iters > done:
                captured.add(importance)
                want["captures"] += 1
        want["replays"] += iters - done
    if dict(counts) != want:
        raise AssertionError(f"{phase}: mapping ran {counts}, expected "
                             f"{want} ({mode}) for the mapped frames "
                             f"{frames}")


def run_slam(cfg, phase: str = "slam",
             config: str = "configs/Synthetic/room.yaml",
             setup=None) -> tuple:
    """SLAMSystem's loop on ``cfg`` with K1/K2 launches counted from zero
    and checked per group against its iterations (a periodic mesh's K1
    launches, one per volume chunk and per chunk of vertex colors, and a
    panel's, three per image chunk, apart); the trajectory and ATE (under
    2 cm); how tracking ran (``check_graph_counts``).  ``setup(slam)``
    runs before the loop.  Emits the frames' lines; returns the phase record (not
    emitted) and the system."""
    import numpy as np
    import torch

    from myslam_torch.engine import mapper, tracker
    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.ops import cuda_sample

    slam = SLAMSystem(cfg, seed=SEED, device=DEVICE)
    if setup is not None:
        setup(slam)
    n_frames = slam.n_img
    t_iters = int(cfg["tracking"]["iters"])
    # Launches per group (its tracked frames and the mapped frame that
    # closes it), read after each mapped frame; each periodic mesh's, and
    # each panel's.
    groups, meshes, panels = [], [], []

    def count_group(system, idx):
        recs = [r for r in system.frame_log
                if r["frame"] > (groups[-1]["frame"] if groups else -1)]
        n_it = (t_iters * sum("track_loss_first" in r for r in recs)
                + recs[-1]["map_iters"])
        coarse = recs[-1]["map_iters"] if recs[-1]["map_importance"] else 0
        groups.append({"frame": idx, "iterations": n_it, "coarse": coarse,
                       "meshes": len(meshes), "panels": len(panels),
                       "launches": dict(cuda_sample.LAUNCHES)})

    extract = slam._extract_and_cull_mesh

    def counted_mesh(path, *a, **k):
        before = dict(cuda_sample.LAUNCHES)
        out = extract(path, *a, **k)
        verts, _, _ = check_mesh_file(path)
        got = {n: cuda_sample.LAUNCHES[n] - before[n] for n in before}
        want = (len(slam.mesher.volume_chunks())
                + -(-len(verts) // slam.mesher.color_batch))
        if got != {**got, "plane_sample_fwd": want, "plane_sample_bwd": 0,
                   "plane_sample_fwd_smem": 0}:
            raise AssertionError(f"{phase}: mesh launches {got}, expected "
                                 f"{want} of K1 and no other")
        meshes.append(got)
        return out

    def counted_render(render, n_chunks):
        def wrapped(*a, **k):
            before = dict(cuda_sample.LAUNCHES)
            out = render(*a, **k)
            got = {n: cuda_sample.LAUNCHES[n] - before[n] for n in before}
            if got != {**got, "plane_sample_fwd": 3 * n_chunks,
                       "plane_sample_bwd": 0, "plane_sample_fwd_smem": 0}:
                raise AssertionError(f"{phase}: panel launches {got}, "
                                     f"expected {3 * n_chunks} of K1 and "
                                     "no other")
            panels.append(got)
            return out
        return wrapped

    # The mapped frames given panels (they map eagerly).
    hooked = set()
    make_hook = slam._make_map_vis_hook

    def noted_hook(idx, pkt):
        hook = make_hook(idx, pkt)
        if hook is not None:
            hooked.add(idx)
        return hook

    slam._make_map_vis_hook = noted_hook
    n_px = slam.cam.H * slam.cam.W
    n_chunks = -(-n_px // min(IMAGE_CHUNK, n_px))
    for vis in (slam.track_vis, slam.map_vis):
        vis._render_img = counted_render(vis._render_img, n_chunks)
    slam.on_map_done = count_group
    slam._extract_and_cull_mesh = counted_mesh
    torch.cuda.reset_peak_memory_stats()
    cuda_sample.reset_launches()
    tracker.GRAPH_COUNTS.update(captures=0, replays=0, eager_iters=0)
    mapper.GRAPH_COUNTS.update(captures=0, replays=0, eager_iters=0)
    t0 = time.perf_counter()
    slam.run_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_sample.LAUNCHES)

    tracked = [r for r in slam.frame_log if "track_ms" in r]
    mapped = [r for r in slam.frame_log if "map_ms" in r]
    for r in slam.frame_log:
        emit({"phase": phase + "_frame", **r})

    def launch_sum(calls):
        return {n: sum(c[n] for c in calls) for n in launches}

    before, seen, seen_p = {name: 0 for name in SLAM_KERNELS}, 0, 0
    for g in groups:
        in_group = launch_sum(meshes[seen:g["meshes"]]
                            + panels[seen_p:g["panels"]])
        for name in SLAM_KERNELS:
            grown = g["launches"][name] - before[name] - in_group[name]
            want = SAMPLES_PER_ITER * g["iterations"] + (
                g["coarse"] if name == "plane_sample_fwd" else 0)
            if grown != want:
                raise AssertionError(
                    f"{name}: {grown} launches in the group ending at frame "
                    f"{g['frame']}, expected {SAMPLES_PER_ITER} per each of "
                    f"its {g['iterations']} iterations and (K1) one per "
                    f"importance iteration ({g['coarse']})")
        before, seen, seen_p = g["launches"], g["meshes"], g["panels"]
    expected = expected_launches(slam)
    other = launch_sum(meshes + panels)
    check_launches({n: launches[n] - other[n] for n in launches}, expected)
    graph_counts = dict(tracker.GRAPH_COUNTS)
    check_graph_counts(phase, graph_counts, t_iters, len(tracked),
                       slam.device.type == "cuda" and not slam.track_sharded)
    map_graph_counts = dict(mapper.GRAPH_COUNTS)
    check_map_graph_counts(
        phase, map_graph_counts,
        [(r["map_iters"], r["map_importance"], r["frame"] in hooked)
         for r in mapped],
        map_mode(slam.parallel, slam.plan, slam.n_proc,
                 slam.store.host_mode, slam.device.type == "cuda"))
    losses = [v for r in slam.frame_log for k, v in r.items()
              if "loss" in k]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{phase}: non-finite loss on the main path")
    est = slam.estimates
    if est.shape != (n_frames, 4, 4) or not np.isfinite(est).all():
        raise AssertionError(f"{phase}: trajectory is not finite")
    ate_cm = slam.ate()["absolute_translational_error.rmse"] * 100.0
    # The JAX package reaches well under 1 cm on this scene; a broken
    # tracker drifts by centimeters within a few frames.
    if not ate_cm < 2.0:
        raise AssertionError(f"{phase}: ATE {ate_cm:.3f} cm on {n_frames} "
                             "frames")
    steady = [r["map_ms"] for r in mapped if r["frame"] > 0]
    out = {
        "phase": phase, "config": config,
        "frames": n_frames, "cam": [slam.cam.H, slam.cam.W],
        "keyframe_device": slam.keyframe_device, "store": slam.store.mode,
        "sdf_rows": slam.sdf_layout.total_rows,
        "color_rows": slam.color_layout.total_rows,
        "tracked_frames": len(tracked), "mapped_frames": len(mapped),
        "track_ms_mean": float(np.mean([r["track_ms"] for r in tracked])),
        "track_ms": [r["track_ms"] for r in tracked],
        "map_ms_steady_mean": float(np.mean(steady)),
        "map_ms_steady": steady,
        "map_ms_frame0": mapped[0]["map_ms"],
        "frame0_s": mapped[0]["map_ms"] / 1e3,
        "wall_s": wall, "ate_rmse_cm": ate_cm, "launches": launches,
        "graph_counts": graph_counts, "map_graph_counts": map_graph_counts,
        "expected_launches": expected, "mesh_launches": meshes,
        "panel_launches": launch_sum(panels), "panels": len(panels),
        "calls": sample_calls(slam),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "frame_start_s": [t - slam.frame_start_wall[0]
                          for t in slam.frame_start_wall],
    }
    return out, slam


def check_mesh_file(path: str) -> tuple:
    """A non-empty mesh with finite vertices and faces that index them."""
    import numpy as np

    from myslam_torch.utils.ply import read_ply

    verts, faces, colors = read_ply(path)
    if len(faces) == 0:
        raise AssertionError(f"{path}: empty mesh")
    if not np.isfinite(verts).all():
        raise AssertionError(f"{path}: non-finite vertex")
    if faces.min() < 0 or faces.max() >= len(verts):
        raise AssertionError(f"{path}: face index out of range")
    if colors is not None and colors.shape != verts.shape:
        raise AssertionError(f"{path}: colors {colors.shape}")
    return verts, faces, colors


def finalize_checked(slam) -> tuple:
    """The SLAM run's finalize(): checkpoint, final mesh and its culled
    copy, with K1's launches counted from zero (one per volume chunk and
    per chunk of vertex colors, no other kernel).  Returns the record,
    the mesh's vertices and its colors."""
    import torch

    from myslam_torch.ops import cuda_sample

    mesher = slam.mesher
    cuda_sample.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ckpt = slam.finalize()
    torch.cuda.synchronize()
    finalize_s = time.perf_counter() - t0
    launches = dict(cuda_sample.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    raw = os.path.join(slam.output, "mesh", slam.mesh_name)
    verts, faces, colors = check_mesh_file(raw)
    cverts, cfaces, _ = check_mesh_file(slam.final_mesh)
    if colors is None:
        raise AssertionError(f"{raw}: no vertex colors")
    sdf_chunks = len(mesher.volume_chunks())
    color_chunks = -(-len(verts) // mesher.color_batch)
    expected = sdf_chunks + color_chunks
    if (launches["plane_sample_fwd"] != expected
            or launches["plane_sample_bwd"] or
            launches["plane_sample_fwd_smem"]):
        raise AssertionError(f"meshing launches {launches}, expected "
                             f"{expected} of K1 and no other")
    xs, ys, zs = mesher.grid_axes()
    out = {"checkpoint": ckpt, "mesh": raw,
           "culled": slam.final_mesh, "grid": [len(xs), len(ys), len(zs)],
           "n_verts": len(verts), "n_tris": len(faces),
           "n_verts_culled": len(cverts), "n_tris_culled": len(cfaces),
           "stages_s": mesher.stages,
           "finalize_s": finalize_s, "finalize_steps_s":
           slam.finalize_seconds, "launches": launches,
           "expected_launches": expected, "sdf_chunks": sdf_chunks,
           "color_chunks": color_chunks, "peak_mem_gb": peak_gb}
    return out, verts, colors


def run_mesh(slam) -> dict:
    """The SLAM run's finalize() (finalize_checked), K1 on the first
    chunk of vertex colors; then the analytic GT mesh, both meshes culled
    in eval_rec mode with the run's frames (GT poses, as
    tools/eval_synthetic_recon.py does) and the 3-D metrics."""
    import copy

    from myslam_torch.tools.cull_mesh import cull_mesh
    from myslam_torch.tools.eval_recon import calc_3d_metric
    from myslam_torch.utils.datasets import Prefetcher

    out, verts, colors = finalize_checked(slam)
    raw = out["mesh"]
    out = {"phase": "mesh", **out}
    emit(out)
    out["color_case"] = check_color_chunk(slam, verts, colors)

    cfg = copy.deepcopy(slam.cfg)
    cfg["meshing"]["eval_rec"] = True
    steps = {}
    t = time.perf_counter()
    gt = slam.dataset.save_gt_mesh(
        os.path.join(slam.output, "mesh", "gt_mesh.ply"),
        resolution=GT_RESOLUTION, device=DEVICE)
    steps["gt_mesh_s"] = time.perf_counter() - t
    t = time.perf_counter()
    frames = [(d, p) for _, (c, d, p) in
              Prefetcher(slam.dataset, range(slam.n_img))]
    steps["frames_s"] = time.perf_counter() - t
    culled = {}
    for name, path in (("rec", raw), ("gt", gt)):
        t = time.perf_counter()
        culled[name] = cull_mesh(path, cfg, frames, out_file=os.path.join(
            slam.output, "mesh", f"{name}_eval_rec.ply"), device=DEVICE)
        steps[f"cull_{name}_s"] = time.perf_counter() - t
    gv, gf, _ = check_mesh_file(gt)
    rv, rf, _ = check_mesh_file(culled["rec"])
    _, cgf, _ = check_mesh_file(culled["gt"])
    t = time.perf_counter()
    metrics = calc_3d_metric(culled["rec"], culled["gt"])
    steps["metric_3d_s"] = time.perf_counter() - t
    rec = {"phase": "mesh_eval", "gt_resolution": GT_RESOLUTION,
           "frames": slam.n_img, "gt_verts": len(gv), "gt_tris": len(gf),
           "rec_eval_rec_tris": len(rf), "gt_eval_rec_tris": len(cgf),
           **metrics, **steps}
    emit(rec)
    # The JAX package reached 0.32 cm at 120 frames on a TPU; a broken
    # map or mesher is off by decimeters.
    if not metrics["accuracy_cm"] <= 2.0:
        raise AssertionError(f"accuracy {metrics['accuracy_cm']:.3f} cm "
                             "exceeds 2 cm")
    return {**out, **rec}


def run_replay(output: str) -> dict:
    """visualizer_torch.replay of the phase-slam run (its newest
    checkpoint and its culled meshes) with the depth rasterizer on the
    card: every REPLAY_EVERY-th frame, each decoded at (H, W, 3); each
    mesh's background depth from the card's rasterizer equal, element
    for element, to the CPU rasterizer's on the same mesh and camera,
    and covering at least REPLAY_MIN_COVER of the frame."""
    import torch

    import visualizer_torch as vt
    from myslam_torch.utils.imageio import read_jpeg
    from myslam_torch.utils.meshmath import make_depth_rasterizer
    from myslam_torch.utils.ply import read_ply

    t = time.perf_counter()
    frames = vt.replay(output, every=REPLAY_EVERY, device=DEVICE)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t
    n = len(vt._load_run(output)[0])
    want = [f"{i:05d}.jpg" for i in range(0, n, REPLAY_EVERY)]
    if [os.path.basename(f) for f in frames] != want:
        raise AssertionError(f"replay frames {frames}, expected {want}")
    for f in frames:
        if read_jpeg(f).shape != (vt.H, vt.W, 3):
            raise AssertionError(f"{f}: shape {read_jpeg(f).shape}")
    sched = vt._mesh_schedule(output, n)
    if not sched:
        raise AssertionError(f"no culled mesh under {output}/mesh")
    w2c = vt.mesh_view(read_ply(sched[-1][1])[0])
    args = (vt.H, vt.W, vt.FOCAL, vt.FOCAL, vt.W / 2, vt.H / 2)
    card = make_depth_rasterizer(*args, device=DEVICE)
    cpu = make_depth_rasterizer(*args, device="cpu")
    meshes = []
    for at, path in sched:
        t = time.perf_counter()
        d_card = vt.mesh_depth(path, w2c, card)
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        d_cpu = vt.mesh_depth(path, w2c, cpu)
        cpu_s = time.perf_counter() - t
        cover = float((d_card > 0).mean())
        differ = int((d_card != d_cpu).sum())
        meshes.append({"mesh": os.path.relpath(path, output), "at": at,
                       "cover": cover, "pixels_differ": differ,
                       "card_s": card_s, "cpu_s": cpu_s})
        if differ or cover < REPLAY_MIN_COVER:
            raise AssertionError(f"replay background of {path}: {differ} "
                                 f"pixels differ from the CPU rasterizer's, "
                                 f"cover {cover:.3f}")
    rec = {"phase": "replay", "output": output, "every": REPLAY_EVERY,
           "frames": len(frames), "replay_s": replay_s, "meshes": meshes}
    emit(rec)
    return rec


def run_bench_scatter() -> dict:
    """K3's path: the bench_scatter tool's gather and scatter sections at
    room0 scale, with K3's launches counted from zero."""
    from myslam_torch.ops import cuda_sample
    from myslam_torch.tools import bench_scatter

    cuda_sample.reset_launches()
    t0 = time.perf_counter()
    recs = bench_scatter.bench_gather(BENCH_POINTS, BENCH_ITERS, DEVICE,
                                      seed=SEED, log=lambda s: None)
    recs += bench_scatter.bench_scatter(BENCH_POINTS, BENCH_ITERS, DEVICE,
                                        seed=SEED, log=lambda s: None)
    wall = time.perf_counter() - t0
    launches = dict(cuda_sample.LAUNCHES)
    for rec in recs:
        emit({"phase": "bench_scatter", **rec})
    k3 = {r["atlas"]: r for r in recs if r.get("name") == "smem_bf16"}
    for atlas in ("sdf-atlas(0.06m)", "color-atlas(0.03m)"):
        rec = k3.get(atlas, {})
        # Tolerance: K3 against K1 and the plain version on the same bf16
        # quad, 1e-5 of the largest value.
        if "skipped" in rec or not (
                rec.get("rel_err_vs_k1_bf16", 1.0) <= 1e-5
                and rec.get("rel_err_vs_plain_bf16", 1.0) <= 1e-5):
            raise AssertionError(f"K3 on {atlas}: {rec}")
    if not k3["sdf-atlas(0.06m)"]["cluster_blocks"] >= 3:
        raise AssertionError(f"K3 on the room0 SDF atlas ran in a cluster "
                             f"of {k3['sdf-atlas(0.06m)']['cluster_blocks']}")
    if launches["plane_sample_fwd_smem"] == 0:
        raise AssertionError("K3 was not launched by bench_scatter")
    out = {"phase": "bench_scatter", "wall_s": wall, "launches": launches,
           "points": BENCH_POINTS, "iters": BENCH_ITERS}
    emit(out)
    return out


def run_bench_exact() -> dict:
    """bench_torch.py's exact lane, cut to N_FRAMES, then its final
    checkpoint loaded into a fresh SLAMSystem."""
    import numpy as np
    import torch

    import bench_torch
    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.ops import cuda_sample

    args = bench_torch.parse_args([
        "--lanes", "exact", "--frames", str(N_FRAMES),
        "--warmup-frames", str(EXACT_WARMUP), "--seed", str(SEED),
        "--device", DEVICE,
        "--output", os.path.join("output", "chip_smoke", "bench")])
    cuda_sample.reset_launches()
    rec, slam = bench_torch.run_lane(args, exact=True, seed=SEED)
    launches = dict(cuda_sample.LAUNCHES)
    check_launches(launches, expected_launches(slam))
    if not math.isfinite(rec["value"]) or rec["value"] <= 0:
        raise AssertionError(f"exact lane fps {rec['value']}")
    if not rec["ate_rmse_cm"] < 2.0:
        raise AssertionError(f"exact lane ATE {rec['ate_rmse_cm']} cm")

    t0 = time.perf_counter()
    path = slam.finalize(mesh=False, checkpoint=True)
    ckpt_s = time.perf_counter() - t0
    fresh = SLAMSystem(slam.cfg, output=slam.output, seed=SEED + 1,
                       device=DEVICE)
    start = fresh.resume()
    a, b = slam.map_state, fresh.map_state
    same = {
        "sdf_atlas": torch.equal(a.sdf_atlas, b.sdf_atlas),
        "color_atlas": torch.equal(a.color_atlas, b.color_atlas),
        "decoder": all(torch.equal(x, y) for x, y in zip(
            a.decoder.state_dict().values(),
            b.decoder.state_dict().values())),
        "trajectory": torch.equal(slam.est, fresh.est) and np.array_equal(
            slam.gt_poses, fresh.gt_poses),
    }
    if start != N_FRAMES or not all(same.values()):
        raise AssertionError(f"checkpoint {path}: start {start}, {same}")
    out = {"phase": "bench_exact", **rec, "launches": launches,
           "expected_launches": expected_launches(slam),
           "checkpoint": path, "checkpoint_s": ckpt_s,
           "resume_start": start, "bit_equal": same}
    emit(out)
    return out


def tum_config(keyframe_device: str | None, frames: int = STORE_FRAMES,
               cache_lines: int | None = None) -> dict:
    """TUM_CONFIG as committed, cut to ``frames`` frames; with
    ``keyframe_device`` in place of its own (``cpu``), and
    ``mapping.host_cache_lines`` if given."""
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    cfg = load_config(TUM_CONFIG, DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = frames
    if keyframe_device is not None:
        cfg["keyframe_device"] = keyframe_device
    if cache_lines is not None:
        cfg["mapping"]["host_cache_lines"] = cache_lines
    cfg["data"]["output"] = os.path.join(
        "output", "chip_smoke",
        f"{cfg['keyframe_device']}_{frames}_{cache_lines}")
    return cfg


def store_record(slam) -> dict:
    """The store's device bytes and dtypes; for the packed store also the
    float16/float32 store's bytes at the same capacity (exactly twice)."""
    st = slam.store
    cap, H, W = st.capacity, slam.cam.H, slam.cam.W

    def info(names):
        return {n: {"dtype": str(getattr(st, n).dtype).replace("torch.", ""),
                    "device": str(getattr(st, n).device),
                    "shape": list(getattr(st, n).shape)} for n in names}

    rec = {"capacity": cap, "store_imagery_bytes": st.imagery_bytes()}
    if st.packed:
        float_bytes = cap * H * W * (3 * 2 + 4)
        rec.update(buffers=info(("colors", "depths_u16", "depth_inv_q")),
                   inv_q_bytes=st.depth_inv_q.numel() * 4,
                   float_store_imagery_bytes=float_bytes,
                   ratio_to_float_store=st.imagery_bytes() / float_bytes)
        if 2 * st.imagery_bytes() != float_bytes:
            raise AssertionError(f"packed store: {rec}")
    else:
        rec.update(buffers=info(("colors_u8", "depths_u16", "depth_inv_q",
                                 "cache_colors", "cache_depths",
                                 "cache_inv_q")),
                   host_pinned=bool(st.colors_u8.is_pinned()
                                    and st.depths_u16.is_pinned()),
                   host_store_bytes=cap * H * W * 5,
                   cache_lines=st.cache_lines, cache_misses=st.cache_misses,
                   cache_bytes=st.imagery_bytes(),
                   selection_fetches=slam.selection_fetches)
    return rec


def check_resume(slam) -> dict:
    """The newest checkpoint of ``slam`` resumed into a fresh SLAMSystem
    of its config: the store's wire-format imagery, poses and records
    byte for byte, and the map and trajectory bit for bit."""
    import torch

    from myslam_torch.engine.scheduler import SLAMSystem

    fresh = SLAMSystem(slam.cfg, output=slam.output, seed=SEED + 1,
                       device=DEVICE)
    start = fresh.resume()
    a, b = slam.store, fresh.store
    n = a.count
    same = {name: torch.equal(x[:n], y[:n]) for name, x, y in zip(
        ("color_u8", "depth_u16", "inv_q"), a.wire(), b.wire())}
    same.update({name: torch.equal(getattr(a, name)[:n],
                                   getattr(b, name)[:n])
                 for name in ("est_c2w", "gt_c2w")})
    same["records"] = (b.count == n and b.frame_ids == a.frame_ids
                       and b.has_depthless == a.has_depthless)
    same["map"] = (torch.equal(slam.map_state.sdf_atlas,
                               fresh.map_state.sdf_atlas)
                   and torch.equal(slam.map_state.color_atlas,
                                   fresh.map_state.color_atlas))
    same["trajectory"] = torch.equal(slam.est, fresh.est)
    if start != slam.n_img or not all(same.values()):
        raise AssertionError(f"resume of {slam.store.mode}: start {start}, "
                             f"{same}")
    return {"resume_start": start, "byte_equal": same}


def run_slam_packed() -> tuple:
    """Phase slam_packed: the TUM schedule as committed (packed store),
    then its checkpoint resumed.  Returns the record and the trajectory."""
    import torch

    cfg = tum_config(None)
    rec, slam = run_slam(cfg, "slam_packed", TUM_CONFIG)
    if slam.store.mode != "packed":
        raise AssertionError(f"{TUM_CONFIG} built a {slam.store.mode} store")
    t0 = time.perf_counter()
    path = slam.finalize(mesh=False)
    torch.cuda.synchronize()
    rec = {**rec, **store_record(slam), "cut": f"{STORE_FRAMES} frames",
           "checkpoint": path, "checkpoint_s": time.perf_counter() - t0,
           **check_resume(slam)}
    emit(rec)
    return rec, slam.estimates


def translation_diff(est, ref):
    """Per-frame distance (m) between two trajectories' positions."""
    import numpy as np

    return np.linalg.norm(est[:, :3, 3] - ref[:, :3, 3], axis=-1)


def run_packed_again(packed_est) -> float:
    """Phase slam_packed_again: phase slam_packed's run once more, with
    the same seed and draws.  On the card K2's float atomics sum in a
    varying order, so the two runs part; their largest per-frame
    distance is the noise floor that phase slam_host_staged is read
    against.  Returns it."""
    rec, slam = run_slam(tum_config(None), "slam_packed_again", TUM_CONFIG)
    diff = translation_diff(slam.estimates, packed_est)
    emit({**rec, "cut": f"{STORE_FRAMES} frames",
          "max_translation_diff_vs_packed_m": float(diff.max()),
          "translation_diff_vs_packed_m": diff.tolist()})
    return float(diff.max())


def run_slam_host_staged(packed_est, floor_m: float) -> dict:
    """Phase slam_host_staged: the same run on the host-staged store,
    against phase slam_packed's trajectory (within STORE_GATE_M per
    frame; ``floor_m`` is two packed runs' distance); then finalize()
    (checkpoint, mesh from the host-side depths, cull) and the checkpoint
    resumed.  Returns the record and the trajectory."""
    from myslam_torch.utils import mesher

    cfg = tum_config("host_staged")
    rec, slam = run_slam(cfg, "slam_host_staged", TUM_CONFIG)
    store = store_record(slam)
    if slam.store.mode != "host_staged" or not store["host_pinned"]:
        raise AssertionError(f"host_staged store: {store}")
    store["bound_lines"] = slam.store.check_cache()
    mapped = rec["mapped_frames"]
    if slam.selection_fetches != mapped:
        raise AssertionError(f"{slam.selection_fetches} selection fetches "
                             f"for {mapped} mapped frames")
    # The two stores make the same draws and read the same bytes, so the
    # runs part only as two packed runs do.
    diff = translation_diff(slam.estimates, packed_est)
    if not diff.max() < STORE_GATE_M:
        raise AssertionError(f"host_staged against packed: {diff} m, "
                             f"two packed runs {floor_m} m")
    hull_calls = []
    backproject = mesher.backproject_keyframes

    def counted(store_, cam, *a, **k):
        hull_calls.append(store_.count)
        return backproject(store_, cam, *a, **k)

    mesher.backproject_keyframes = counted
    try:
        fin, _, _ = finalize_checked(slam)
    finally:
        mesher.backproject_keyframes = backproject
    if hull_calls != [slam.store.count]:
        raise AssertionError(f"host-side hull calls {hull_calls}")
    rec = {**rec, **store, "cut": f"{STORE_FRAMES} frames",
           "max_translation_diff_vs_packed_m": float(diff.max()),
           "translation_diff_vs_packed_m": diff.tolist(),
           "packed_noise_floor_m": floor_m, "gate_m": STORE_GATE_M,
           "finalize": fin, **check_resume(slam)}
    emit(rec)
    return rec, slam.estimates


def run_host_evict(floor_m: float) -> dict:
    """Phase host_evict: the host-staged store on TUM_CONFIG cut to
    EVICT_FRAMES frames, a window of EVICT_WINDOW keyframes,
    EVICT_TRACK_ITERS tracking iterations and EVICT_ITERS_FIRST mapping
    iterations on frame 0, two runs of one seed: the configured cache
    (one
    line per slot and the scratch line: nothing is evicted) and the
    smallest (``host_cache_lines: 1`` clamps to w_max + 1 lines, so
    admissions evict and later windows upload evicted slots again while
    the previous frame's kernels run).  The evicting run must miss, and
    stay within STORE_GATE_M per frame of the other (``floor_m`` is two
    packed runs' distance).  In both runs each bound line must hold its
    slot's host imagery byte for byte."""
    runs = {}
    for name, lines in (("full", None), ("min", 1)):
        cfg = tum_config("host_staged", EVICT_FRAMES, lines)
        cfg["mapping"]["mapping_window_size"] = EVICT_WINDOW
        cfg["tracking"]["iters"] = EVICT_TRACK_ITERS
        cfg["mapping"]["iters_first"] = EVICT_ITERS_FIRST
        rec, slam = run_slam(cfg, "host_evict_" + name, TUM_CONFIG)
        runs[name] = {
            "est": slam.estimates, "cache_lines": slam.store.cache_lines,
            "cache_misses": slam.store.cache_misses,
            "selection_fetches": slam.selection_fetches,
            "bound_lines": slam.store.check_cache(),
            "mapped_frames": rec["mapped_frames"],
            "w_max": slam.w_max, "launches": rec["launches"],
            **{k: rec[k] for k in ("track_ms_mean", "map_ms_steady_mean",
                                   "frame0_s", "ate_rmse_cm")}}
        del slam
    full, small = runs["full"], runs["min"]
    gap = translation_diff(small["est"], full["est"])
    if (small["cache_lines"] != small["w_max"] + 1
            or not small["cache_misses"] > 0
            or full["cache_misses"] != 0
            or any(r["selection_fetches"] != r["mapped_frames"]
                   for r in runs.values())):
        raise AssertionError(f"host_evict: {runs}")
    if not gap.max() < STORE_GATE_M:
        raise AssertionError(f"host_evict: evicting run {gap} m from the "
                             f"other; two packed runs {floor_m} m")
    out = {"phase": "host_evict", "config": TUM_CONFIG,
           "cut": f"{EVICT_FRAMES} frames, a window of {EVICT_WINDOW}, "
                  f"{EVICT_TRACK_ITERS} tracking iterations, "
                  f"{EVICT_ITERS_FIRST} on frame 0",
           "runs": {k: {kk: v for kk, v in r.items() if kk != "est"}
                    for k, r in runs.items()},
           "max_translation_diff_evicting_m": float(gap.max()),
           "translation_diff_evicting_m": gap.tolist(),
           "packed_noise_floor_m": floor_m, "gate_m": STORE_GATE_M}
    emit(out)
    return out


def run_codec() -> dict:
    """Phase codec: PNG round trips byte for byte, the JPEG round trip
    at quality 95 within OpenCV's error on the same render, decode and
    encode times on full-width frames, and ``import cv2``'s outcome."""
    import numpy as np

    from myslam_torch.utils import imageio
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
    from myslam_torch.utils.datasets import Synthetic

    t0 = time.perf_counter()
    library = imageio.build()
    build_s = time.perf_counter() - t0
    cfg = load_config("configs/Synthetic/room.yaml", DEFAULT_CONFIG)
    color, depth, _ = Synthetic(cfg).get_frame(0)
    rgb = (np.clip(color, 0, 1) * 255).astype(np.uint8)
    d16 = np.clip(depth * 6553.5, 0, 65535).astype(np.uint16)

    def timed(fn):
        fn()
        t = time.perf_counter()
        for _ in range(CODEC_REPS):
            out = fn()
        return out, (time.perf_counter() - t) / CODEC_REPS * 1e3

    png_rgb, ms_png_rgb_enc = timed(lambda: imageio.encode_png(rgb))
    png_d16, ms_png_enc = timed(lambda: imageio.encode_png(d16))
    back_rgb, ms_png_rgb_dec = timed(lambda: imageio.read_png(png_rgb))
    back_d16, ms_png_dec = timed(lambda: imageio.read_png(png_d16))
    if not (np.array_equal(back_rgb, rgb) and np.array_equal(back_d16, d16)
            and back_d16.dtype == np.uint16):
        raise AssertionError("codec: a PNG round trip is not byte-equal")
    jpg, ms_jpeg_enc = timed(lambda: imageio.encode_jpeg(rgb, 95))
    jpg98 = imageio.encode_jpeg(rgb, 98)
    back, ms_jpeg_dec = timed(lambda: imageio.read_jpeg(jpg98))
    back = imageio.read_jpeg(jpg)
    err = np.abs(back.astype(np.int64) - rgb)
    max_err, mean_err = int(err.max()), float(err.mean())
    # Tolerance: what OpenCV's q95 4:2:0 round trip costs on this render.
    if not (max_err <= JPEG_Q95_MAX_ERR and mean_err <= JPEG_Q95_MEAN_ERR):
        raise AssertionError(
            f"codec: JPEG q95 round trip max {max_err} / mean {mean_err:.4f}"
            f" against OpenCV's {JPEG_Q95_MAX_ERR} / {JPEG_Q95_MEAN_ERR}")
    # Which image libraries this machine has (the port uses none).
    probe = ("import importlib.util, json; print(json.dumps({m: "
             "importlib.util.find_spec(m) is not None for m in "
             "('cv2', 'PIL', 'torchvision', 'matplotlib')}))")
    libs = json.loads(subprocess.run(
        [sys.executable, "-c", probe], capture_output=True, text=True,
        timeout=120, check=True).stdout)
    cv2 = subprocess.run([sys.executable, "-c", "import cv2"],
                         capture_output=True, text=True, timeout=120)
    out = {"phase": "codec", "library": library, "build_s": build_s,
           "frame": list(rgb.shape), "png_rgb_bytes": len(png_rgb),
           "png_depth_bytes": len(png_d16), "png_byte_equal": True,
           "jpeg_q95_bytes": len(jpg), "jpeg_q98_bytes": len(jpg98),
           "jpeg_q95_max_err": max_err, "jpeg_q95_mean_err": mean_err,
           "gate_max_err": JPEG_Q95_MAX_ERR,
           "gate_mean_err": JPEG_Q95_MEAN_ERR,
           "ms_jpeg_decode": ms_jpeg_dec, "ms_jpeg_encode": ms_jpeg_enc,
           "ms_png_depth_decode": ms_png_dec,
           "ms_png_depth_encode": ms_png_enc,
           "ms_png_rgb_decode": ms_png_rgb_dec,
           "ms_png_rgb_encode": ms_png_rgb_enc,
           "import_cv2_rc": cv2.returncode,
           "import_cv2": (cv2.stderr.strip().splitlines() or ["ok"])[-1],
           "image_libraries": libs}
    emit(out)
    return out


def write_config(path: str, cfg: dict) -> str:
    """A YAML config file (the committed configs stay as they are)."""
    import yaml

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def count_mappers(slam, calls: list) -> None:
    """Record each mapped frame's importance branch (True: the depth-less
    sampling branch, which depth holes require)."""
    for imp, mapper in list(slam._mappers.items()):
        def counted(*a, _imp=imp, _m=mapper, **k):
            calls.append(_imp)
            return _m(*a, **k)
        slam._mappers[imp] = counted


def check_metrics(path: str, frames: int) -> dict:
    """metrics.jsonl holds each frame once, in order, with the JAX
    package's keys (tracked frames: track_loss_first/best, track_ms;
    mapped ones: map_loss, map_ms; all: frame_ms)."""
    import numpy as np

    with open(path) as f:
        recs = [json.loads(ln) for ln in f]
    got = [r["frame"] for r in recs if "frame" in r]
    if got != list(range(frames)):
        raise AssertionError(f"{path}: frames {got}")
    for r in recs:
        if "frame" not in r:
            continue
        keys = {"frame_ms"}
        if r["frame"] > 0:
            keys |= {"track_loss_first", "track_loss_best", "track_ms"}
        if "map_iters" in r:
            keys |= {"map_loss", "map_ms"}
        if not keys <= set(r) or not all(
                np.isfinite(r[k]) for k in keys):
            raise AssertionError(f"{path}: record {r}")
    return {"records": len(recs), "frame_records": len(got),
            "build_records": [r for r in recs if r.get("phase") == "build"]}


def run_replica_layout(runs: int = 1, gate_m: float | None = None) -> dict:
    """Phase replica_layout: the room exported to the Replica layout and
    run from disk, ``runs`` times in this process (the first run's
    trajectory is the reference; a second one reads the card's noise),
    then under ``run_torch.py --supervise`` killed at KILL_FRAME and
    resumed, within ``gate_m`` (None: not gated) of the first run."""
    import numpy as np

    from myslam_torch.tools.export_synthetic import export_replica
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
    from myslam_torch.utils.datasets import Synthetic
    from myslam_torch.utils.logger import latest_checkpoint

    root = os.path.abspath(os.path.join("output", "chip_smoke", "replica"))
    shutil.rmtree(root, ignore_errors=True)  # a stale fault marker
    room = load_config(REPLICA_SOURCE, DEFAULT_CONFIG)
    room["data"]["n_frames"] = REPLICA_FRAMES
    data = os.path.join(root, "data")
    t0 = time.perf_counter()
    export_replica(room, data, holes=True)
    export_s = time.perf_counter() - t0
    runs_out, ests = [], []
    for r in range(runs):
        out_dir = os.path.join(root, f"run{r}")
        cfg_path = write_config(os.path.join(root, f"run{r}.yaml"), {
            "inherit_from": os.path.abspath(REPLICA_CONFIG),
            "verbose": True,
            "data": {"input_folder": data, "output": out_dir},
            "mapping": {"bound": room["mapping"]["bound"],
                        "marching_cubes_bound":
                        room["mapping"]["marching_cubes_bound"],
                        "ckpt_freq": 4, "mesh_freq": 8}})
        cfg = load_config(cfg_path, DEFAULT_CONFIG)
        branches = []
        rec, slam = run_slam(cfg, f"replica_layout_run{r}", REPLICA_CONFIG,
                             setup=lambda s: count_mappers(s, branches))
        gt_err = float(np.abs(slam.gt_poses - np.stack(
            Synthetic(room).poses)).max())
        if slam.n_img != REPLICA_FRAMES or not gt_err <= 1e-5:
            raise AssertionError(f"replica reader: {slam.n_img} frames, "
                                 f"poses {gt_err} from Synthetic's")
        if not (branches and all(branches)
                and any(slam.store.has_depthless[:slam.store.count])):
            raise AssertionError(f"replica: importance branch {branches}")
        metrics = check_metrics(slam.metrics_path, slam.n_img)
        if [b["frame"] for b in slam.bookkeeping] != [4, 8]:
            raise AssertionError(f"replica: bookkeeping {slam.bookkeeping}")
        ests.append(slam.estimates)
        runs_out.append({**rec, "gt_pose_max_err": gt_err,
                         "importance_branch": branches, **metrics,
                         "bookkeeping": slam.bookkeeping,
                         "compile_secs": slam.compile_secs})
        del slam
    noise = [float(translation_diff(e, ests[0]).max()) for e in ests[1:]]

    # The supervised run, killed at KILL_FRAME's start and restarted.
    sup_dir = os.path.join(root, "supervised")
    sup_cfg = os.path.join(root, "run0.yaml")
    env = dict(os.environ, MYSLAM_FAULT_KILL=str(KILL_FRAME))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "run_torch.py", sup_cfg, "--output", sup_dir,
         "--seed", str(SEED), "--device", DEVICE, "--supervise"], env=env,
        capture_output=True,
        text=True, timeout=900)
    sup_s = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    with open(os.path.join(root, "supervised.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    restarts = [ln for ln in lines if ln.startswith("SUPERVISOR: job")]
    resumed = [ln for ln in lines if ln.startswith("Resumed from")]
    want_ckpt = os.path.join(sup_dir, "ckpts", f"{KILL_FRAME - 1:05d}.npz")
    result = json.loads(lines[-1]) if lines and lines[-1].startswith(
        "{") else {}
    if (proc.returncode != 0 or len(restarts) != 1
            or resumed != [f"Resumed from {want_ckpt} at frame {KILL_FRAME}"]
            or result.get("resumed_from") != KILL_FRAME):
        raise AssertionError(
            f"supervised run: rc {proc.returncode}, {restarts}, {resumed}, "
            f"{result}; stderr {proc.stderr[-2000:]}")
    files = {name: os.path.exists(os.path.join(sup_dir, name)) for name in (
        "ckpts/00004.npz", "ckpts/00008.npz", "ckpts/00012.npz",
        "mesh/00008_mesh.ply", "mesh/00008_mesh_culled.ply",
        "mesh/final_mesh_eval_rec.ply", "mesh/final_mesh_eval_rec_culled.ply",
        "HEARTBEAT", "FAULT_INJECTED")}
    if not all(files.values()):
        raise AssertionError(f"supervised run: files {files}")
    for mesh in ("mesh/00008_mesh_culled.ply",
                 "mesh/final_mesh_eval_rec_culled.ply"):
        check_mesh_file(os.path.join(sup_dir, mesh))
    sup_metrics = check_metrics(os.path.join(sup_dir, "metrics.jsonl"),
                                REPLICA_FRAMES)
    ate = subprocess.run(
        [sys.executable, "-m", "myslam_torch.tools.eval_ate", sup_cfg,
         "--output", sup_dir], capture_output=True, text=True, timeout=300)
    printed = dict(ln.split(": ", 1) for ln in ate.stdout.splitlines()
                   if ": " in ln)
    rmse_cli = float(printed.get("absolute_translational_error.rmse", "nan"))
    if ate.returncode or not abs(rmse_cli * 100.0
                                 - result["ate_rmse_cm"]) <= 1e-9:
        raise AssertionError(f"eval_ate: {ate.stdout} {ate.stderr[-1000:]}"
                             f" against {result['ate_rmse_cm']} cm")
    with np.load(latest_checkpoint(os.path.join(sup_dir, "ckpts")),
                 allow_pickle=True) as ck:
        sup_est = ck["estimate_c2w_list"]
    gap = translation_diff(sup_est, ests[0])
    if gate_m is not None and not gap.max() < gate_m:
        raise AssertionError(f"supervised run {gap} m from the first run; "
                             f"gate {gate_m} m")
    out = {"phase": "replica_layout", "config": REPLICA_CONFIG,
           "frames": REPLICA_FRAMES,
           "cam": [room["cam"]["H"], room["cam"]["W"]],
           "export_s": export_s, "runs": runs_out,
           "noise_max_translation_diff_m": noise,
           "supervised": {
               "wall_s": sup_s, "restarts": restarts, "resumed": resumed,
               "result": result, "files": files, **sup_metrics,
               "eval_ate_rmse_cm": rmse_cli * 100.0,
               "max_translation_diff_m": float(gap.max()),
               "translation_diff_m": gap.tolist(), "gate_m": gate_m}}
    emit(out)
    return out


def run_tum_layout() -> dict:
    """Phase tum_layout: the room exported to the TUM layout at 480x640,
    read back with freiburg1_desk.yaml's crop under tum.yaml's schedule,
    the bound moved into the rebased frame."""
    import numpy as np

    from myslam_torch.tools.export_synthetic import export_tum, \
        transform_bound, tum_world_transform
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    root = os.path.abspath(os.path.join("output", "chip_smoke", "tum"))
    shutil.rmtree(root, ignore_errors=True)
    src = load_config(TUM_CONFIG, DEFAULT_CONFIG)
    src["data"]["n_frames"] = TUM_LAYOUT_FRAMES
    desk = load_config(TUM_CROP_CONFIG, DEFAULT_CONFIG)
    crop, edge = desk["cam"]["crop_size"], desk["cam"]["crop_edge"]
    data = os.path.join(root, "data")
    t0 = time.perf_counter()
    export_tum(src, data, holes=True)
    export_s = time.perf_counter() - t0
    A = tum_world_transform(src)
    cam = {k: src["cam"][k] for k in ("H", "W", "fx", "fy", "cx", "cy")}
    cfg_path = write_config(os.path.join(root, "tum_layout.yaml"), {
        "inherit_from": os.path.abspath(TUM_LAYOUT_CONFIG),
        "data": {"input_folder": data, "output": os.path.join(root, "out")},
        "cam": {**cam, "crop_size": crop, "crop_edge": edge,
                "distortion": [0.0] * 5},
        "mapping": {
            "bound": transform_bound(src["mapping"]["bound"], A),
            "marching_cubes_bound": transform_bound(
                src["mapping"]["marching_cubes_bound"], A)}})
    cfg = load_config(cfg_path, DEFAULT_CONFIG)
    branches = []
    rec, slam = run_slam(cfg, "tum_layout", TUM_LAYOUT_CONFIG,
                         setup=lambda s: count_mappers(s, branches))
    first = slam.gt_poses[0]
    checks = {
        "first_pose": bool(np.array_equal(
            first, np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32))),
        "associated": slam.n_img == TUM_LAYOUT_FRAMES,
        # 384x512 less the 8-pixel edge: 368x496
        "camera": [slam.cam.H, slam.cam.W] == [crop[0] - 2 * edge,
                                               crop[1] - 2 * edge],
        "importance_branch": bool(branches) and all(branches),
    }
    if not all(checks.values()):
        raise AssertionError(f"tum_layout: {checks}, {branches}")
    out = {**rec, "export_s": export_s, "checks": checks,
           "importance_branch": branches,
           **check_metrics(slam.metrics_path, slam.n_img)}
    emit(out)
    return out


def expected_panels(slam) -> list[str]:
    """The panel files the JAX package's gating gives for this run's
    schedule (myslam_tpu/engine/scheduler.py: ``_maybe_track_vis``, every
    tracked frame with idx % tracking.vis_freq == 0 at iterations 0,
    inside_freq, ...; ``_make_map_vis_hook``, every mapped frame with
    idx % mapping.vis_freq == 0, frame 0 only without
    no_vis_on_first_frame, at iteration 0 and every multiple of
    inside_freq below the frame's iterations)."""
    cfg, n = slam.cfg, slam.n_img
    t, m = cfg["tracking"], cfg["mapping"]
    t_freq, t_in = max(int(t["vis_freq"]), 1), max(int(t["vis_inside_freq"]),
                                                   1)
    m_freq, m_in = max(int(m["vis_freq"]), 1), max(int(m["vis_inside_freq"]),
                                                   1)
    names = []
    for idx in range(n):
        if idx > 0 and idx % t_freq == 0:
            names += [f"tracking_vis/{idx:05d}_{it:04d}.jpg"
                      for it in range(0, int(t["iters"]), t_in)]
        mapped = idx % int(m["every_frame"]) == 0 or idx == n - 1
        if (mapped and idx % m_freq == 0
                and not (idx == 0 and m["no_vis_on_first_frame"])):
            iters = int(m["iters_first"] if idx == 0 else m["iters"])
            names += [f"mapping_vis/{idx:05d}_{it:04d}.jpg"
                      for it in [0, *range(m_in, iters, m_in)]]
    return sorted(names)


def check_image_chunk(slam) -> dict:
    """One panel of the last frame rendered again on the run's final map,
    alone: its seconds and peak memory; then once more with K1's inputs
    caught at chunk IMAGE_CHUNK_INDEX's two fine samples (SDF and color,
    f32 quads, 1,638,400 ray-ordered points at 680x1200), where K1 is
    held against its plain version and timed."""
    import torch

    from myslam_torch.core.sampling import TorchDraws
    from myslam_torch.ops import cuda_sample
    from myslam_torch.render.renderer import make_image_renderer
    from myslam_torch.tools.bench_sample_bwd import row_updates

    dev = torch.device(DEVICE)
    idx = slam.n_img - 1
    _, depth, _ = slam.dataset.get_frame(idx)
    gt_depth = torch.as_tensor(depth, dtype=torch.float32).to(dev)
    c2w = slam.est[idx]
    render = make_image_renderer(slam.scene, slam.cam, IMAGE_CHUNK)
    ms = slam.map_state
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    render(ms, c2w, gt_depth, TorchDraws(SEED, dev))
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    caught = []
    fwd = cuda_sample.plane_sample_fwd
    first = 3 * IMAGE_CHUNK_INDEX + 1  # the chunk's coarse pass comes first

    def catch(quad, layout, p_nor):
        if catch.calls in (first, first + 1):
            caught.append((quad, layout, p_nor))
        catch.calls += 1
        return fwd(quad, layout, p_nor)

    catch.calls = 0
    cuda_sample.plane_sample_fwd = catch
    try:
        render(ms, c2w, gt_depth, TorchDraws(SEED, dev))
    finally:
        cuda_sample.plane_sample_fwd = fwd
    out = {"case": "image_chunk", "chunk": IMAGE_CHUNK_INDEX,
           "frame": idx, "render_s": render_s,
           "render_peak_gb": peak / 1e9,
           "render_own_peak_gb": (peak - base) / 1e9}
    for (quad, layout, p_nor), name, atlas in zip(
            caught, ("sdf", "color"),
            (ms.sdf_atlas.detach(), ms.color_atlas.detach())):
        C = layout.c_dim
        planes = [atlas[off:off + H * W].reshape(H, W, C).permute(2, 0, 1)
                  [None].contiguous()
                  for _, _, _, _, H, W, off in layout.planes()]
        rows = row_updates(layout, p_nor, cuda_sample.FWD_RUN)
        rec, _, _ = check_fwd(quad, layout, p_nor, rows, planes)
        out[name] = {"rows": layout.total_rows, "points": p_nor.shape[0],
                     "quad_dtype": str(quad.dtype).replace("torch.", ""),
                     "fwd": rec}
    if len(caught) != 2:
        raise AssertionError(f"caught {len(caught)} of the chunk's two "
                             "fine samples")
    emit({"phase": "kernels", **out})
    return out


def run_vis() -> dict:
    """The panels: room.yaml at full width for VIS_FRAMES frames with
    VIS_SETTINGS (run_slam: K1 exactly 3 per image chunk per panel over
    the loop's own launches, K2 the loop's alone; ATE); the panel files
    against the JAX package's gating, each decoded at (2H, 3W, 3), each
    rendered depth within VIS_DEPTH_GATE_M of the input on average; then
    check_image_chunk."""
    import glob

    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
    from myslam_torch.utils.imageio import read_jpeg

    cfg = load_config("configs/Synthetic/room.yaml", DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = VIS_FRAMES
    cfg["data"]["output"] = os.path.join("output", "chip_smoke", "vis")
    for section, values in VIS_SETTINGS.items():
        cfg[section].update(values)
    shutil.rmtree(cfg["data"]["output"], ignore_errors=True)
    out, slam = run_slam(cfg, phase="vis")
    records = slam.track_vis.records + slam.map_vis.records
    want = expected_panels(slam)
    written = sorted(os.path.relpath(r["file"], slam.output)
                     for r in records)
    on_disk = sorted(os.path.relpath(p, slam.output) for p in glob.glob(
        os.path.join(slam.output, "*_vis", "*.jpg")))
    if not (written == on_disk == want):
        raise AssertionError(f"panels {written}, on disk {on_disk}, "
                             f"expected {want}")
    H, W = slam.cam.H, slam.cam.W
    for r in records:
        shape = read_jpeg(r["file"]).shape
        r["shape"] = list(shape)
        if shape != (2 * H, 3 * W, 3):
            raise AssertionError(f"{r['file']}: decoded {shape}")
        if not r["depth_l1_m"] <= VIS_DEPTH_GATE_M:
            raise AssertionError(f"{r['file']}: mean depth error "
                                 f"{r['depth_l1_m']:.4f} m")
    n_chunks = -(-H * W // IMAGE_CHUNK)
    k1, k2 = "plane_sample_fwd", "plane_sample_bwd"
    if (out["launches"][k1] != out["expected_launches"][k1]
            + 3 * n_chunks * len(want)
            or out["launches"][k2] != out["expected_launches"][k2]):
        raise AssertionError(f"vis launches {out['launches']}, expected "
                             f"{out['expected_launches']} and "
                             f"{3 * n_chunks} of K1 per panel")
    out.update(panel_files=want, panel_records=records,
               image_chunks=n_chunks,
               panel_s=[r["seconds"] for r in records])
    emit(out)
    out["image_chunk"] = check_image_chunk(slam)
    return out


def run_tool(main, argv) -> dict:
    """A tool's main(argv) with its printing caught, and K1/K2 launches
    counted from zero: its report with them (``launches``); fails unless
    both kernels ran."""
    import contextlib
    import io

    from myslam_torch.ops import cuda_sample

    cuda_sample.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        rep = main(argv)
    rep["launches"] = dict(cuda_sample.LAUNCHES)
    if not all(rep["launches"][name] for name in SLAM_KERNELS):
        raise AssertionError(f"{main.__module__}: launches "
                             f"{rep['launches']}")
    return rep


def run_components() -> dict:
    """tools/profile_components.py on room.yaml's top-K lane: per
    component ms (events), device_ms (torch.profiler) and launches per
    call."""
    from myslam_torch.tools import profile_components

    rep = run_tool(profile_components.main,
                   ["--iters", str(COMPONENT_ITERS), "--device", DEVICE,
                    "--json"])
    for name, c in rep["components"].items():
        if not (c["ms"] > 0 and c["device_ms"] and c["launches"]):
            raise AssertionError(f"component {name}: {c}")
    out = {"phase": "components", **rep}
    emit(out)
    return out


def run_raysweep() -> dict:
    """tools/bench_raysweep.py at its five ray counts, RAYSWEEP_REPS
    windows each: the fit and the rows."""
    from myslam_torch.tools import bench_raysweep

    rep = run_tool(bench_raysweep.main,
                   ["--reps", str(RAYSWEEP_REPS), "--device", DEVICE,
                    "--json"])
    for lane in rep["lanes"].values():
        if not all(math.isfinite(t) and t > 0 for t in lane["iter_ms"]):
            raise AssertionError(f"raysweep {lane}")
    out = {"phase": "raysweep", **rep}
    emit(out)
    return out


def gang_config(name: str, parallel: dict,
                mapping: dict | None = None) -> str:
    """GANG_CONFIG at full width cut to N_FRAMES frames under ``parallel``,
    a checkpoint every 4 frames and no periodic mesh; its output folder
    emptied.  Returns the config file's path."""
    root = os.path.abspath(os.path.join("output", "chip_smoke", name))
    shutil.rmtree(root, ignore_errors=True)
    return write_config(root + ".yaml", {
        "inherit_from": os.path.abspath(GANG_CONFIG),
        "data": {"n_frames": N_FRAMES, "output": root},
        "mapping": {"ckpt_freq": 4, "mesh_freq": 10 ** 6,
                    **(mapping or {})},
        "parallel": parallel})


def gang_expected(rec: dict) -> dict:
    """K1 and K2 launches one rank's loop must make, the reduced pose
    system's apart: SAMPLES_PER_ITER of each per tracking and mapping
    iteration, and K1 once more per importance iteration."""
    its = (rec["tracked_frames"] * rec["track_iters"]
           + sum(rec["map_iters"]))
    coarse = sum(n for n, imp in zip(rec["map_iters"], rec["map_importance"])
                 if imp)
    return {"plane_sample_fwd": SAMPLES_PER_ITER * its + coarse,
            "plane_sample_bwd": SAMPLES_PER_ITER * its,
            "plane_sample_fwd_banded": 0, "plane_sample_bwd_banded": 0}


def banded_expected(rec: dict) -> dict:
    """Launches one rank of the map shards must make: K1/K2 for tracking
    (the replicated map), the banded K1/K2 for mapping (the bands)."""
    t_its = rec["tracked_frames"] * rec["track_iters"]
    m_its = sum(rec["map_iters"])
    coarse = sum(n for n, imp in zip(rec["map_iters"], rec["map_importance"])
                 if imp)
    return {"plane_sample_fwd": SAMPLES_PER_ITER * t_its,
            "plane_sample_bwd": SAMPLES_PER_ITER * t_its,
            "plane_sample_fwd_banded": SAMPLES_PER_ITER * m_its + coarse,
            "plane_sample_bwd_banded": SAMPLES_PER_ITER * m_its}


def run_gang(phase: str, config: str, ate_gate_cm: float = 2.0,
             ranks: int = GANG_RANKS, frames: int = N_FRAMES,
             grads: bool = True, expected=gang_expected) -> list:
    """SLAMSystem's loop on ``config`` over ``ranks`` ranks on the card
    (``multiproc.launch``, ``run_system``: each rank counts its kernel
    launches from zero around the loop).  Every rank must finish, hold
    rank 0's trajectory bit for bit, stay under ``ate_gate_cm`` ATE,
    launch the kernels as its iterations say (``expected``), track as
    ``check_graph_counts`` says, and with
    ``grads`` make one gradient all-reduce per mapping iteration.  Emits
    one line per rank; returns the ranks' records."""
    import numpy as np

    from myslam_torch.parallel import multiproc

    t0 = time.perf_counter()
    recs = multiproc.launch(ranks, loop="system", config=config,
                            device=DEVICE, seed=SEED, frames=frames,
                            timeout=900)
    wall = time.perf_counter() - t0
    # Plain lists, but the trajectories.
    recs = [{k: (v.tolist() if isinstance(v, np.ndarray)
                 and k not in ("est", "gt") else v) for k, v in rec.items()}
            for rec in recs]
    for r, rec in enumerate(recs):
        est = np.asarray(rec["est"])
        if (rec["rank"] != r or est.shape != (frames, 4, 4)
                or not np.isfinite(est).all()
                or not np.array_equal(est, np.asarray(recs[0]["est"]))):
            raise AssertionError(f"{phase}: rank {r}'s trajectory is not "
                                 "rank 0's")
        if not rec["ate_rmse_cm"] < ate_gate_cm:
            raise AssertionError(f"{phase}: ATE {rec['ate_rmse_cm']} cm, "
                                 f"gate {ate_gate_cm}")
        want = expected(rec)
        got = {n: rec["launches"][n] - rec["schur_launches"].get(n, 0)
               for n in want}
        if got != want or rec["launches"]["plane_sample_fwd_smem"]:
            raise AssertionError(f"{phase}: rank {r} launches "
                                 f"{rec['launches']} (pose system "
                                 f"{rec['schur_launches']}), loop {want}")
        check_graph_counts(f"{phase} rank {r}", rec["graph_counts"],
                           rec["track_iters"], rec["tracked_frames"],
                           rec["device"].startswith("cuda")
                           and not rec["track_sharded"])
        check_map_graph_counts(
            f"{phase} rank {r}", rec["map_graph_counts"],
            [(n, imp, False) for n, imp in zip(rec["map_iters"],
                                               rec["map_importance"])],
            map_mode(rec["parallel"], rec["plan"], rec["world"],
                     rec["store_mode"] == "host_staged",
                     rec["device"].startswith("cuda")))
        if grads and rec["grad_allreduces"] != rec["map_iters"]:
            raise AssertionError(
                f"{phase}: rank {r} gradient all-reduces per mapped frame "
                f"{rec['grad_allreduces']}, iterations {rec['map_iters']}")
        grad = rec["collectives"].get(
            "grad_rs", rec["collectives"].get(
                "grad", {"bytes": 0, "calls": 0, "seconds": 0.0}))
        calls = max(grad["calls"], 1)
        emit({"phase": phase, "rank": r, "backend": rec["backend"],
              "device": rec["device"], "parallel": rec["parallel"],
              "pipeline_role": rec["pipeline_role"],
              "pose_solver": rec["pose_solver"], "frames": frames,
              "ate_rmse_cm": rec["ate_rmse_cm"], "wall_s": rec["wall_s"],
              "track_ms": rec["track_ms"], "map_ms": rec["map_ms"],
              "map_frames": rec["map_frames"], "map_iters": rec["map_iters"],
              "track_ms_mean": (float(np.mean(rec["track_ms"]))
                                if rec["track_ms"] else None),
              "map_ms_frame0": rec["map_ms"][0] if rec["map_ms"] else None,
              "map_ms_steady_mean": (float(np.mean(rec["map_ms"][1:]))
                                     if len(rec["map_ms"]) > 1 else None),
              "launches": rec["launches"],
              "schur_launches": rec["schur_launches"],
              "tracked_frames": rec["tracked_frames"],
              "track_sharded": rec["track_sharded"],
              "graph_counts": rec["graph_counts"],
              "map_graph_counts": rec["map_graph_counts"],
              "grad_allreduces_per_mapped_frame": rec["grad_allreduces"],
              "ba_moves_m": rec["ba_moves_m"],
              "grad_allreduce_bytes": grad["bytes"] // calls,
              "grad_allreduce_ms_mean": 1e3 * grad["seconds"] / calls,
              "collectives": rec["collectives"],
              "peak_mem_gb": rec["peak_mem_gb"],
              "ckpt_extra_mem_bytes": rec["ckpt_extra_mem_bytes"],
              "store_mode": rec["store_mode"],
              "store_capacity": rec["store_capacity"],
              "store_local_capacity": rec["store_local_capacity"],
              "store_imagery_bytes": rec["store_imagery_bytes"],
              "gang_wall_s": wall})
    return recs


def gang_speed(recs: list, slam_rec: dict) -> dict:
    """Rank 0's tracked- and mapped-frame ms beside phase slam's."""
    import numpy as np

    r0 = recs[0]
    return {"track_ms_mean": float(np.mean(r0["track_ms"])),
            "map_ms_frame0": r0["map_ms"][0],
            "map_ms_steady_mean": float(np.mean(r0["map_ms"][1:])),
            "slam_track_ms_mean": slam_rec["track_ms_mean"],
            "slam_map_ms_frame0": slam_rec["map_ms_frame0"],
            "slam_map_ms_steady_mean": slam_rec["map_ms_steady_mean"]}


def run_dp(slam_rec: dict, slam_est) -> list:
    """Phase dp: ray data parallelism (``parallel.devices``) on GANG_RANKS
    ranks, within DP_GATE_M per frame of phase slam's single-rank
    trajectory.  Returns the ranks' records."""
    recs = run_gang("dp", gang_config("dp", {"devices": GANG_RANKS}))
    vs_slam = translation_diff(recs[0]["est"], slam_est)
    if not vs_slam.max() < DP_GATE_M:
        raise AssertionError(f"dp: {vs_slam} m from phase slam's "
                             f"trajectory; gate {DP_GATE_M} m")
    emit({"phase": "dp_summary", "ranks": GANG_RANKS,
          "backend": recs[0]["backend"],
          "launches": [r["launches"] for r in recs],
          "peak_mem_gb": [r["peak_mem_gb"] for r in recs],
          **gang_speed(recs, slam_rec),
          "max_translation_diff_vs_slam_m": float(vs_slam.max()),
          "translation_diff_vs_slam_m": vs_slam.tolist(),
          "gate_m": DP_GATE_M})
    return recs


def run_kf_schur(slam_rec: dict, name: str = "kf_schur",
                 schedule: dict | None = None,
                 ate_gate_cm: float = 2.0) -> dict:
    """Phase kf_schur: keyframe-sharded BA (``parallel.kf_shards``) with
    the reduced (Schur) pose solve on GANG_RANKS ranks, on room.yaml's
    schedule (``schedule``: mapping keys that replace it; phase
    kf_schur_every).  Each rank's keyframe imagery must be at most half
    the single-rank store's (the same config on one rank, built here)
    plus one slot, the pose system must have launched K2, and a
    checkpoint, whose imagery is gathered to rank 0, must take no other
    rank more device memory than a slot.  With ``schedule`` the solve
    must move a stored keyframe by BA_MOVE_MIN_M in some frame."""
    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    config = gang_config(name, {"kf_shards": GANG_RANKS,
                                "pose_solver": "schur"}, schedule)
    single_cfg = load_config(config, DEFAULT_CONFIG)
    single_cfg["parallel"] = {}
    single = SLAMSystem(single_cfg, seed=SEED, device=DEVICE).store
    single_bytes = single.imagery_bytes()
    slot_bytes = single_bytes // single.capacity
    del single
    recs = run_gang(name, config, ate_gate_cm)
    for r, rec in enumerate(recs):
        if not rec["store_imagery_bytes"] <= single_bytes / 2 + slot_bytes:
            raise AssertionError(
                f"{name}: rank {r} holds {rec['store_imagery_bytes']} "
                f"bytes of imagery; one rank's store {single_bytes}")
        if not rec["schur_launches"]["plane_sample_bwd"] > 0:
            raise AssertionError(f"{name}: rank {r} pose system "
                                 f"{rec['schur_launches']}")
        if r > 0 and not rec["ckpt_extra_mem_bytes"] <= slot_bytes:
            raise AssertionError(
                f"{name}: rank {r} took {rec['ckpt_extra_mem_bytes']} "
                f"device bytes for a checkpoint; a slot is {slot_bytes}")
    moved = max(recs[0]["ba_moves_m"])
    if schedule is not None and not moved > BA_MOVE_MIN_M:
        raise AssertionError(f"{name}: the solve moved no stored keyframe "
                             f"({recs[0]['ba_moves_m']} m)")
    out = {"phase": name + "_summary", "ranks": GANG_RANKS,
           "schedule": schedule, "backend": recs[0]["backend"],
           "launches": [r["launches"] for r in recs],
           "schur_launches": [r["schur_launches"] for r in recs],
           "store_imagery_bytes": [r["store_imagery_bytes"] for r in recs],
           "single_rank_store_imagery_bytes": single_bytes,
           "peak_mem_gb": [r["peak_mem_gb"] for r in recs],
           "ckpt_extra_mem_bytes": [r["ckpt_extra_mem_bytes"]
                                    for r in recs],
           "max_ba_move_m": moved,
           **gang_speed(recs, slam_rec),
           "ate_rmse_cm": recs[0]["ate_rmse_cm"],
           "ate_gate_cm": ate_gate_cm}
    emit(out)
    return out


def check_schur_pullback(system) -> dict:
    """K2 without the quad gradient at the reduced pose system's call: on
    phase slam's final map and keyframes, keyframe-sharded BA's pose
    system (exact color) over one rank's rays (mapping.pixels /
    GANG_RANKS) from a window of every keyframe; the first pullback's
    cotangent, points and quad against K2's plain version, within 1e-5
    of the largest value, as phase kernels holds K2."""
    import torch

    from myslam_torch.core.geometry import rays_from_uv
    from myslam_torch.core.quaternion import cam_pose_to_matrix, \
        matrix_to_cam_pose
    from myslam_torch.core.sampling import TorchDraws
    from myslam_torch.engine.mapper import map_quad_dtype
    from myslam_torch.ops import cuda_sample
    from myslam_torch.parallel.distributed_ba import make_local_ray_picker, \
        make_pose_system
    from myslam_torch.render.renderer import build_z_vals_core, make_queries

    cfg, store, cam, scene = system.cfg, system.store, system.cam, \
        system.scene
    dev = system.device
    n = store.count
    slot_kf = torch.zeros((system.w_max,), dtype=torch.long, device=dev)
    slot_kf[:n] = torch.arange(n, device=dev)
    poses = matrix_to_cam_pose(store.est_c2w[slot_kf])
    n_rays = int(cfg["mapping"]["pixels"]) // GANG_RANKS
    draws = TorchDraws(SEED, dev)
    p, i, j, depth, color, valid = make_local_ray_picker(
        cam, n_rays, store.packed)(slot_kf, n, store.imagery(),
                                   store.local_capacity, draws)
    with torch.no_grad():
        rays_o, rays_d = rays_from_uv(i, j, cam_pose_to_matrix(poses)[p],
                                      cam.fx, cam.fy, cam.cx, cam.cy)
        z_vals = build_z_vals_core(
            draws, scene, rays_o, rays_d, depth, False,
            make_queries(system.map_state, scene,
                         quad_dtype=map_quad_dtype(cfg)))
    calls = []
    real = cuda_sample.plane_sample_bwd

    def keep(gbar, quad, layout, p_nor, need_quad_grad=True):
        calls.append((gbar.clone(), quad, layout, p_nor.clone(),
                      need_quad_grad))
        return real(gbar, quad, layout, p_nor, need_quad_grad)

    cuda_sample.plane_sample_bwd = keep
    try:
        make_pose_system(cfg, scene, cam)(system.map_state, poses, p, i, j,
                                          depth, color, z_vals, valid)
    finally:
        cuda_sample.plane_sample_bwd = real
    gbar, quad, layout, p_nor, need_quad = calls[0]
    if need_quad or any(c[4] for c in calls):
        raise AssertionError("the pose system asked K2 for a quad gradient")
    _, got = real(gbar, quad, layout, p_nor, need_quad_grad=False)
    _, ref = cuda_sample.plane_sample_bwd_ref(gbar, quad, layout, p_nor,
                                              need_quad_grad=False)
    torch.cuda.synchronize()
    err, rel = scaled_err(got, ref)
    if not rel <= 1e-5:
        raise AssertionError(f"K2 at the Schur pullback: error {rel:.3e} "
                             "of the largest value exceeds 1e-5")
    from myslam_torch.tools.bench_sample_bwd import row_updates

    b_ms, b_by, b_bytes = bwd_bound(
        p_nor.shape[0], layout, quad.element_size(),
        row_updates(layout, p_nor, cuda_sample.BWD_RUN), False)
    out = {"phase": "kernels", "case": "schur_pullback", "rays": n_rays,
           "points": p_nor.shape[0], "layout_rows": layout.total_rows,
           "quad_dtype": str(quad.dtype).replace("torch.", ""),
           "k2_calls": len(calls),
           "bwd_p_grad_only": {
               "max_abs_err": err, "rel_err": rel,
               "ms": time_ms(lambda: real(gbar, quad, layout, p_nor,
                                          need_quad_grad=False)),
               "plain_ms": time_ms(lambda: cuda_sample.plane_sample_bwd_ref(
                   gbar, quad, layout, p_nor, need_quad_grad=False),
                   reps=5),
               "bytes": b_bytes, "bound_ms": b_ms, "bound_by": b_by}}
    emit(out)
    return out


def run_gang_resume(dp_recs: list, again: Background) -> dict:
    """Phase gang_resume: ``run_torch.py --launch GANG_RANKS --supervise``
    on phase dp's config, rank 1 killed at frame KILL_FRAME
    (MYSLAM_FAULT_KILL): the launcher kills rank 0, the supervisor
    restarts the gang once from rank 0's checkpoint of frame
    KILL_FRAME - 1, both ranks start at KILL_FRAME, and the final
    trajectory stays within GANG_RESUME_GATE_M per frame of phase dp's
    run.  ``again`` runs phase dp_again meanwhile: phase dp's run once
    more with the same seed, whose distance from phase dp is the gang's
    run-to-run spread on the card."""
    import numpy as np

    config = gang_config("dp", {"devices": GANG_RANKS})
    out_dir = os.path.abspath(os.path.join("output", "chip_smoke",
                                           "gang_resume"))
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, MYSLAM_FAULT_KILL=GANG_KILL)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "run_torch.py", config, "--output", out_dir,
             "--seed", str(SEED), "--device", DEVICE, "--launch",
             str(GANG_RANKS), "--supervise"], env=env, capture_output=True,
            text=True, timeout=900)
    finally:
        again_recs = again.join()
    wall = time.perf_counter() - t0
    spread = translation_diff(again_recs[0]["est"], dp_recs[0]["est"])
    with open(out_dir + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    lines = proc.stdout.splitlines()
    restarts = [ln for ln in lines if ln.startswith("SUPERVISOR: job")]
    result = json.loads(lines[-1]) if lines and lines[-1].startswith(
        "{") else {}
    starts = [result.get("resumed_from")] + [
        int(ln.rsplit(" ", 1)[1]) for ln in lines
        if ln.startswith("RANK ") and ": resumed_from " in ln][-(
            GANG_RANKS - 1):]
    launches = [result.get("launches")] + [
        json.loads(ln.split(": launches ", 1)[1]) for ln in lines
        if ln.startswith("RANK ") and ": launches " in ln][-(
            GANG_RANKS - 1):]
    if (proc.returncode != 0 or len(restarts) != 1
            or starts != [KILL_FRAME] * GANG_RANKS
            or not all(la and la["plane_sample_fwd"]
                       and la["plane_sample_bwd"] for la in launches)):
        raise AssertionError(
            f"gang_resume: rc {proc.returncode}, {restarts}, starts "
            f"{starts}, launches {launches}; stderr {proc.stderr[-3000:]}")
    with np.load(os.path.join(out_dir, "ckpts",
                              f"{N_FRAMES - 1:05d}.npz"),
                 allow_pickle=True) as ck:
        est = ck["estimate_c2w_list"]
    if not spread.max() < DP_GATE_M:
        raise AssertionError(f"dp_again: {spread} m from phase dp's run; "
                             f"gate {DP_GATE_M} m")
    gap = translation_diff(est, np.asarray(dp_recs[0]["est"]))
    if not gap.max() < GANG_RESUME_GATE_M:
        raise AssertionError(f"gang_resume: {gap} m from phase dp's run; "
                             f"gate {GANG_RESUME_GATE_M} m")
    out = {"phase": "gang_resume", "ranks": GANG_RANKS, "kill": GANG_KILL,
           "wall_s": wall, "restarts": restarts, "starts": starts,
           "result": result, "launches": launches,
           "max_translation_diff_m": float(gap.max()),
           "translation_diff_m": gap.tolist(),
           "max_translation_diff_dp_again_m": float(spread.max()),
           "translation_diff_dp_again_m": spread.tolist(),
           "gate_m": GANG_RESUME_GATE_M, "dp_again_gate_m": DP_GATE_M}
    emit(out)
    return out


def group_walls(start_s: list, bounds: list) -> list:
    """Seconds between the starts of consecutive mapped frames after the
    first two (the steady groups)."""
    return [start_s[b] - start_s[a] for a, b in zip(bounds[1:-1],
                                                    bounds[2:])]


def run_pipeline(slam_rec: dict, slam_est) -> dict:
    """Phase pipeline: the track||map pipeline (``parallel.pipeline``) on
    GANG_RANKS ranks, rank 0 tracking and rank 1 mapping, on room.yaml
    at full width for N_FRAMES frames.  Gates: the ranks' trajectories
    bit for bit and ATE (run_gang), every frame within PIPELINE_GATE_M
    of phase slam's, and every boundary's snapshot the map of the
    boundary before (after frame 0's mapping at frame 0), as the map
    role sent it and the track role took it (sha256 of the bytes).
    Reports the snapshot's bytes and ms per boundary, each role's
    tracked- and mapped-frame ms and the steady group walls beside phase
    slam's."""
    import numpy as np

    recs = run_gang("pipeline", gang_config("pipeline", {"pipeline": True}),
                    grads=False)
    track, mapr = recs
    if (track["pipeline_role"], mapr["pipeline_role"]) != ("track", "map"):
        raise AssertionError("pipeline: rank 0 must track, rank 1 map")
    vs_slam = translation_diff(np.asarray(track["est"]), slam_est)
    if not vs_slam.max() < PIPELINE_GATE_M:
        raise AssertionError(f"pipeline: {vs_slam} m from phase slam's "
                             f"trajectory; gate {PIPELINE_GATE_M} m")
    posted, mapped = (mapr["snapshots"]["posted"],
                      mapr["snapshots"]["mapped"])
    want = [mapped[0]] + mapped[:len(posted) - 1]
    if (not posted or posted != want
            or track["snapshots"]["taken"] != posted):
        raise AssertionError(
            f"pipeline: snapshots posted {posted}, taken "
            f"{track['snapshots']['taken']}, maps {mapped}")
    bounds = mapr["map_frames"]
    snap_t, snap_m = (track["collectives"]["snapshot"],
                      mapr["collectives"]["snapshot"])
    out = {"phase": "pipeline_summary", "ranks": GANG_RANKS,
           "backend": track["backend"], "boundaries": bounds,
           "snapshot_bytes": snap_m["bytes"] // snap_m["calls"],
           "snapshots": snap_m["calls"],
           "snapshot_send_ms_mean": 1e3 * snap_m["seconds"]
           / snap_m["calls"],
           "snapshot_wait_ms_mean": 1e3 * snap_t["seconds"]
           / snap_t["calls"],
           "poses": mapr["collectives"]["poses"],
           # The first group carries the track rank's first kernel
           # launches (in phase slam, frame 0's mapping takes them).
           "track_ms": track["track_ms"],
           "track_ms_steady_mean": float(np.mean(
               track["track_ms"][bounds[1]:])),
           "map_ms_frame0": mapr["map_ms"][0],
           "map_ms_steady_mean": float(np.mean(mapr["map_ms"][1:])),
           "slam_track_ms_mean": slam_rec["track_ms_mean"],
           "slam_track_ms_steady_mean": float(np.mean(
               slam_rec["track_ms"][bounds[1]:])),
           "slam_map_ms_steady_mean": slam_rec["map_ms_steady_mean"],
           "group_walls_s": group_walls(track["frame_start_s"], bounds),
           "slam_group_walls_s": group_walls(slam_rec["frame_start_s"],
                                             bounds),
           "drain_s": track["drain_s"], "ate_rmse_cm": track["ate_rmse_cm"],
           "max_translation_diff_vs_slam_m": float(vs_slam.max()),
           "gate_m": PIPELINE_GATE_M,
           "launches": [r["launches"] for r in recs]}
    emit(out)
    return out


def one_rank_runs(config: str, runs: int):
    """``runs`` runs of the map_shards config's schedule on one rank
    (MAP_SHARDS_FRAMES frames): their trajectories, ATEs (cm) and the
    atlas bytes."""
    import torch

    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    cfg = load_config(config, DEFAULT_CONFIG)
    cfg["parallel"] = {}
    cfg["data"]["n_frames"] = MAP_SHARDS_FRAMES
    est, ate = [], []
    for _ in range(runs):
        single = SLAMSystem(cfg, seed=SEED, device=DEVICE)
        single.run_loop()
        est.append(single.estimates)
        ate.append(single.ate()["absolute_translational_error.rmse"]
                   * 100.0)
        atlas = sum(t.numel() * t.element_size() for t in (
            single.map_state.sdf_atlas, single.map_state.color_atlas))
        del single
        torch.cuda.empty_cache()
    return est, ate, atlas


def run_map_shards() -> dict:
    """Phase map_shards: banded map shards (``parallel.map_shards``) on
    GANG_RANKS ranks on room.yaml at full width, cut to
    MAP_SHARDS_FRAMES frames and MAP_SHARDS_ITERS_FIRST frame-0
    iterations.  One rank's run of the same schedule is made twice
    first: the pair's distance is the card's spread on this schedule (K2's
    atomics).  Gates: ATE and the ranks' trajectories bit for bit
    (run_gang), every rank's replicated map bit for bit, and every frame
    of the pair's and of the gang's run against the first one-rank run
    within MAP_SHARDS_GATE_M.  Reports each rank's atlas bytes (its
    bands) and Adam bytes against one rank's, the features all-reduce's
    bytes and ms per sample call by size, and the banded K1/K2 launches.
    The summary is printed before a gate raises."""
    import numpy as np

    config = gang_config("map_shards", {"map_shards": GANG_RANKS},
                         {"iters_first": MAP_SHARDS_ITERS_FIRST})
    one_est, one_ate, one_atlas = one_rank_runs(config, 2)
    pair = translation_diff(one_est[1], one_est[0])
    recs = run_gang("map_shards", config, frames=MAP_SHARDS_FRAMES,
                    grads=False, expected=banded_expected)
    vs_one = translation_diff(np.asarray(recs[0]["est"]), one_est[0])
    features = {}
    for kind, nbytes, sec in recs[0]["trace"]:
        if kind == "features":
            f = features.setdefault(str(int(nbytes)), {"calls": 0,
                                                       "ms": 0.0})
            f["calls"] += 1
            f["ms"] += 1e3 * float(sec)
    for f in features.values():
        f["ms_mean"] = f.pop("ms") / f["calls"]
    out = {"phase": "map_shards_summary", "ranks": GANG_RANKS,
           "frames": MAP_SHARDS_FRAMES,
           "iters_first": MAP_SHARDS_ITERS_FIRST,
           "atlas_bytes": [r["map_atlas_bytes"] for r in recs],
           "adam_bytes": [2 * r["map_atlas_bytes"] for r in recs],
           "one_rank_atlas_bytes": one_atlas,
           "one_rank_adam_bytes": 2 * one_atlas,
           "features_by_bytes": features,
           "collectives": recs[0]["collectives"],
           "launches": [r["launches"] for r in recs],
           "ate_rmse_cm": recs[0]["ate_rmse_cm"],
           "one_rank_ate_rmse_cm": one_ate,
           "one_rank_pair_diff_m": pair.tolist(),
           "max_translation_diff_one_rank_pair_m": float(pair.max()),
           "translation_diff_vs_one_rank_m": vs_one.tolist(),
           "max_translation_diff_vs_one_rank_m": float(vs_one.max()),
           "gate_m": MAP_SHARDS_GATE_M,
           "maps_equal": len({r["map_digest"] for r in recs}) == 1,
           "track_ms_mean": float(np.mean(recs[0]["track_ms"])),
           "map_ms_frame0": recs[0]["map_ms"][0],
           "map_ms_steady_mean": float(np.mean(recs[0]["map_ms"][1:]))}
    emit(out)
    if not out["maps_equal"]:
        raise AssertionError("map_shards: the ranks' replicated maps differ")
    if not pair.max() < MAP_SHARDS_GATE_M:
        raise AssertionError(f"map_shards: one rank's two runs {pair} m "
                             f"apart; gate {MAP_SHARDS_GATE_M} m")
    if not vs_one.max() < MAP_SHARDS_GATE_M:
        raise AssertionError(f"map_shards: {vs_one} m from one rank's run; "
                             f"gate {MAP_SHARDS_GATE_M} m")
    return out


def run_kf_dp() -> dict:
    """Phase kf_dp: kf_shards x devices on a KF_DP_GRID grid of ranks on
    room.yaml at full width for N_FRAMES frames, frame 0 cut to
    KF_DP_ITERS_FIRST iterations.  Gates (run_gang): ATE,
    every rank's trajectory rank 0's bit for bit, one gradient
    all-reduce per mapping iteration; and each rank's keyframe imagery
    at most half the single-rank store's plus a slot.  Reports the
    imagery per rank."""
    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    k, d = KF_DP_GRID
    config = gang_config("kf_dp", {"kf_shards": k, "devices": d},
                         {"iters_first": KF_DP_ITERS_FIRST})
    single_cfg = load_config(config, DEFAULT_CONFIG)
    single_cfg["parallel"] = {}
    single = SLAMSystem(single_cfg, seed=SEED, device=DEVICE).store
    single_bytes = single.imagery_bytes()
    slot_bytes = single_bytes // single.capacity
    del single
    recs = run_gang("kf_dp", config, ranks=k * d)
    for r, rec in enumerate(recs):
        if not rec["store_imagery_bytes"] <= single_bytes / k + slot_bytes:
            raise AssertionError(
                f"kf_dp: rank {r} holds {rec['store_imagery_bytes']} bytes "
                f"of imagery; one rank's store {single_bytes}")
    out = {"phase": "kf_dp_summary", "grid": [k, d],
           "store_imagery_bytes": [r["store_imagery_bytes"] for r in recs],
           "single_rank_store_imagery_bytes": single_bytes,
           "ate_rmse_cm": recs[0]["ate_rmse_cm"],
           "grad_allreduce_bytes": recs[0]["collectives"]["grad"]["bytes"]
           // recs[0]["collectives"]["grad"]["calls"],
           "launches": [r["launches"] for r in recs],
           "peak_mem_gb": [r["peak_mem_gb"] for r in recs],
           "wall_s": [r["wall_s"] for r in recs]}
    emit(out)
    return out


def run_bigstep() -> dict:
    """Phase bigstep: ``multiproc.run_bigstep`` over GANG_RANKS ranks,
    ray DP and keyframe-sharded BA: BIGSTEP_CHUNKS 15-iteration mapping
    chunks at the Replica operating point each; every loss finite, the
    ranks' losses equal; chunk seconds and each rank's peak RSS."""
    import numpy as np

    from myslam_torch.parallel import multiproc

    out = {"phase": "bigstep", "ranks": GANG_RANKS}
    for mode in ("dp", "kf"):
        recs = multiproc.launch(GANG_RANKS, mode=mode, loop="bigstep",
                                frames=BIGSTEP_CHUNKS, device=DEVICE,
                                seed=SEED, timeout=600)
        for rec in recs:
            losses = np.asarray(rec["losses"])
            if (not np.isfinite(losses).all()
                    or len(rec["chunk_s"]) != BIGSTEP_CHUNKS
                    or not np.array_equal(losses,
                                          np.asarray(recs[0]["losses"]))):
                raise AssertionError(f"bigstep[{mode}]: losses {losses}")
        out[mode] = {"chunk_s": [list(r["chunk_s"]) for r in recs],
                     "rss_mb": [r["rss_mb"] for r in recs]}
    emit(out)
    return out


def run_dp_spmd(slam_rec: dict, slam_est) -> list:
    """Phase dp_spmd: ray DP under ``dp_impl: spmd`` with ``zero_opt``
    (DP_SPMD) on GANG_RANKS ranks (run_gang's gates), every rank's map
    bit for bit (the all-gathered rows), within DP_GATE_M per frame of
    phase slam's trajectory, one ``grad_rs`` (the atlases' padded row
    blocks), one ``grad`` and one ``zero_gather`` per mapping iteration,
    and each rank's Adam moments of the atlases half the replicated
    Adam's, to a row.  Returns the ranks' records."""
    import numpy as np

    from myslam_torch.render.renderer import scene_from_cfg
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    scene = scene_from_cfg(load_config(GANG_CONFIG, DEFAULT_CONFIG))
    padded = sum(4 * -(-lay.total_rows // GANG_RANKS) * GANG_RANKS
                 * lay.c_dim for lay in (scene.sdf_layout,
                                         scene.color_layout))
    recs = run_gang("dp_spmd", gang_config("dp_spmd", DP_SPMD))
    r0 = recs[0]
    vs_slam = translation_diff(np.asarray(r0["est"]), slam_est)
    iters = sum(r0["map_iters"])
    per_rank = []
    for r, rec in enumerate(recs):
        c, adam = rec["collectives"], rec["adam_bytes"]
        # One row of each atlas (32 channels) in both moments: the first
        # rank's block is ceil(rows / 2) rows.
        row_slack = 2 * 2 * 4 * 32
        if (rec["plan"] != {"mode": "dp", "spmd": True, "zero_opt": True}
                or c["grad_rs"]["calls"] != iters
                or c["grad"]["calls"] != iters
                or c["zero_gather"]["calls"] != iters
                or c["grad_rs"]["bytes"] != iters * padded
                or c["zero_gather"]["bytes"] != iters * padded
                or rec["map_digest"] != r0["map_digest"]
                or not 0 < adam["atlas_moments"]
                <= adam["atlas_moments_replicated"] / 2 + row_slack):
            raise AssertionError(f"dp_spmd: rank {r} plan {rec['plan']}, "
                                 f"collectives {c}, Adam {adam}")
        per_rank.append({
            "grad_rs_bytes": c["grad_rs"]["bytes"] // iters,
            "grad_rs_ms_mean": 1e3 * c["grad_rs"]["seconds"] / iters,
            "grad_bytes": c["grad"]["bytes"] // iters,
            "grad_ms_mean": 1e3 * c["grad"]["seconds"] / iters,
            "zero_gather_bytes": c["zero_gather"]["bytes"] // iters,
            "zero_gather_ms_mean": 1e3 * c["zero_gather"]["seconds"]
            / iters, "adam_bytes": adam})
    if not vs_slam.max() < DP_GATE_M:
        raise AssertionError(f"dp_spmd: {vs_slam} m from phase slam's "
                             f"trajectory; gate {DP_GATE_M} m")
    emit({"phase": "dp_spmd_summary", "ranks": GANG_RANKS,
          "parallel": DP_SPMD, "backend": r0["backend"],
          "ate_rmse_cm": r0["ate_rmse_cm"], "map_iters": iters,
          "per_rank": per_rank,
          "launches": [r["launches"] for r in recs],
          "peak_mem_gb": [r["peak_mem_gb"] for r in recs],
          **gang_speed(recs, slam_rec),
          "max_translation_diff_vs_slam_m": float(vs_slam.max()),
          "translation_diff_vs_slam_m": vs_slam.tolist(),
          "gate_m": DP_GATE_M})
    return recs


def run_dp_host_staged() -> list:
    """Phase dp_host_staged's gang: phase slam_host_staged's run (the TUM
    schedule cut to STORE_FRAMES frames, the host-staged store) on
    GANG_RANKS ranks under ray DP (run_gang's gates).  Each rank checks
    its bound cache lines against its host slots (``run_system``).
    Returns the ranks' records; ``check_dp_host_staged`` reads them."""
    cfg = tum_config("host_staged")
    cfg["parallel"] = {"devices": GANG_RANKS}
    root = os.path.abspath(os.path.join("output", "chip_smoke",
                                        "dp_host_staged"))
    shutil.rmtree(root, ignore_errors=True)
    cfg["data"]["output"] = root
    return run_gang("dp_host_staged", write_config(root + ".yaml", cfg),
                    frames=STORE_FRAMES)


def check_dp_host_staged(recs: list, host_rec: dict, host_est) -> dict:
    """Phase dp_host_staged against phase slam_host_staged: every frame
    within STORE_GATE_M, every rank holding the whole host store (its
    bytes), one selection fetch per mapped frame, bound lines checked."""
    import numpy as np

    r0 = recs[0]
    diff = translation_diff(np.asarray(r0["est"]), host_est)
    hosts = [rec["host_store"] for rec in recs]
    for r, (rec, h) in enumerate(zip(recs, hosts)):
        if (rec["store_mode"] != "host_staged" or rec["plan"]["mode"] != "dp"
                or h["host_bytes"] != host_rec["host_store_bytes"]
                or h["selection_fetches"] != len(rec["map_frames"])
                or not h["bound_lines"] > 0):
            raise AssertionError(f"dp_host_staged: rank {r} {h}, plan "
                                 f"{rec['plan']}")
    if not diff.max() < STORE_GATE_M:
        raise AssertionError(f"dp_host_staged: {diff} m from phase "
                             f"slam_host_staged; gate {STORE_GATE_M} m")
    out = {"phase": "dp_host_staged_summary", "ranks": GANG_RANKS,
           "cut": f"{STORE_FRAMES} frames", "host_store": hosts,
           "single_rank_host_store_bytes": host_rec["host_store_bytes"],
           "ate_rmse_cm": r0["ate_rmse_cm"],
           "launches": [r["launches"] for r in recs],
           "max_translation_diff_vs_host_staged_m": float(diff.max()),
           "translation_diff_vs_host_staged_m": diff.tolist(),
           "gate_m": STORE_GATE_M}
    emit(out)
    return out


def run_scaling(dp_recs: list, spmd_recs: list, components: dict,
                sweep: dict, metrics_path: str) -> dict:
    """Phase scaling: tools/validate_scaling.py's rows from phases dp and
    dp_spmd (rank 0's mapping collectives over its mapping iterations):
    plain DP's all-reduce 1.00 of the model's payload, ZeRO's
    reduce-scatter and all-gather the atlases' padded rows and its
    all-reduce the rest of plain DP's;
    tools/scaling_report.py from phases components and raysweep, phase
    dp's link rate and phase slam's host ms per frame (every projected
    fps finite and positive); tools/bench_pose_solver.py on GANG_RANKS
    shards at POSE_SOLVER_BUDGET_S seconds a solver."""
    import contextlib
    import io

    from myslam_torch.render.renderer import scene_from_cfg
    from myslam_torch.tools import bench_pose_solver, scaling_report, \
        validate_scaling
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    cfg = load_config(GANG_CONFIG, DEFAULT_CONFIG)
    model = scaling_report.atlas_grad_bytes(cfg)
    rows = []
    for impl, recs in (("shardmap", dp_recs), ("spmd_zero", spmd_recs)):
        r0 = recs[0]
        counts = {k: v for k, v in r0["collectives"].items()
                  if k in MAP_KINDS}
        rows.append(validate_scaling.row(counts, sum(r0["map_iters"]),
                                         r0["world"], r0["backend"], model,
                                         impl))
    plain, zero = rows
    scene = scene_from_cfg(cfg)
    padded = sum(4 * -(-lay.total_rows // GANG_RANKS) * GANG_RANKS
                 * lay.c_dim for lay in (scene.sdf_layout,
                                         scene.color_layout))
    atlases = sum(4 * lay.total_rows * lay.c_dim
                  for lay in (scene.sdf_layout, scene.color_layout))
    if (round(plain["ratio_vs_model"]["grad"], 2) != 1.0
            or zero["bytes_per_iter"]["grad_rs"] != padded
            or zero["bytes_per_iter"]["grad"]
            != plain["bytes_per_iter"]["grad"] - atlases
            or zero["bytes_per_iter"]["zero_gather"] != padded):
        raise AssertionError(f"validate_scaling rows {rows}")
    link = scaling_report.link_gbps_of(dp_recs[0])
    fixed = scaling_report.fixed_ms_of(metrics_path)
    rep = scaling_report.report(cfg, components, sweep, link, fixed)
    fps = [r["fps"] for lane in rep["lanes"].values()
           for r in lane["dp_projection"] + lane["pipeline_projection"]]
    if not all(math.isfinite(f) and f > 0 for f in fps):
        raise AssertionError(f"scaling_report {rep}")
    with contextlib.redirect_stdout(io.StringIO()):
        pose = bench_pose_solver.main(
            ["--budget-s", str(POSE_SOLVER_BUDGET_S), "--shards",
             str(GANG_RANKS), "--device", DEVICE])
    for name, rec in pose["solvers"].items():
        if not (rec["iters_done"] > 0
                and math.isfinite(rec["err_final_m"])):
            raise AssertionError(f"bench_pose_solver {name}: {rec}")
    out = {"phase": "scaling", "model_grad_bytes": model,
           "validate_scaling": rows, "scaling_report": rep,
           "bench_pose_solver": {
               "err_initial_m": pose["err_initial_m"],
               "winner_at_equal_wall": pose["winner_at_equal_wall"],
               "device": pose["device"], "shards": pose["shards"],
               "solvers": {k: {n: v[n] for n in ("iters_done", "wall_s",
                                                 "ms_per_iter",
                                                 "err_final_m")}
                           for k, v in pose["solvers"].items()}}}
    emit(out)
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--replica-runs", type=int, default=1,
                   help="uninterrupted runs in phase replica_layout")
    args = p.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from myslam_torch.ops import cuda_sample
        from myslam_torch.tools.bench_sample_bwd import layouts, \
            ptxas_report
        from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    library = cuda_sample.build()
    ptxas = [ln.strip() for ln in cuda_sample.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln
             or "Function properties" in ln]
    spilled = {fn: rec for fn, rec in ptxas_report(
        cuda_sample.BUILD_LOG, "").items() if rec.get("spill_bytes")}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": library, "ptxas": ptxas, "spills": spilled})
    # K1, K2 and K3 (plane_sample_fwd, _bwd, _fwd_smem kernels).
    if any("plane_sample_" in fn for fn in spilled):
        raise AssertionError(f"K1, K2 or K3 spills registers: {spilled}")

    cfg = load_config("configs/Synthetic/room.yaml", DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = N_FRAMES
    cases = check_kernels(cfg, layouts(cfg))
    head = next(c for c in cases if c["layout"] == "sdf"
                and c["quad_dtype"] == "bfloat16" and "fwd" in c)
    banded_case = check_banded(cfg, layouts(cfg)["sdf"], head["bwd_rays"])
    mesh_case = check_mesh_chunk(cfg, layouts(cfg)["sdf"])
    slam, system = run_slam(cfg)
    emit(slam)
    mesh = run_mesh(system)
    run_replay(system.output)
    schur_case = check_schur_pullback(system)
    slam_est = system.estimates.copy()
    slam_metrics = os.path.join(system.output, "metrics.jsonl")
    del system
    dp_recs = run_dp(slam, slam_est)
    # Phases kf_schur, kf_schur_every, kf_dp and dp_again run beside
    # gang_resume: none of their times is a recorded number (phase dp's
    # are, alone, as are the pipeline's, map_shards' and bigstep's).
    kf = Background(run_kf_schur, slam)
    kf_every = Background(run_kf_schur, slam, "kf_schur_every",
                          KF_SCHUR_EVERY, KF_SCHUR_EVERY_ATE_CM)
    kf_dp = Background(run_kf_dp)
    spmd = Background(run_dp_spmd, slam, slam_est)
    try:
        resume = run_gang_resume(dp_recs, Background(
            run_gang, "dp_again",
            gang_config("dp_again", {"devices": GANG_RANKS})))
    finally:
        kf.wait()
        kf_every.wait()
        kf_dp.wait()
        spmd.wait()
    kf, kf_every, kf_dp = kf.join(), kf_every.join(), kf_dp.join()
    spmd_recs = spmd.join()
    pipeline = run_pipeline(slam, slam_est)
    shards = run_map_shards()
    bigstep = run_bigstep()
    bench = run_bench_scatter()
    run_bench_exact()
    tum = tum_config(None)
    cases += check_kernels(tum, layouts(tum), TUM_CASES, (TUM_TRACK_CASE,),
                           config=TUM_CONFIG)
    packed, packed_est = run_slam_packed()
    floor = run_packed_again(packed_est)
    host, host_est = run_slam_host_staged(packed_est, floor)
    # Phase dp_host_staged's gang runs beside host_evict.
    dp_host = Background(run_dp_host_staged)
    try:
        evict = run_host_evict(floor)
    finally:
        dp_host.wait()
    dp_host = check_dp_host_staged(dp_host.join(), host, host_est)
    run_codec()
    replica = run_replica_layout(args.replica_runs, RESUME_GATE_M)
    tum_layout = run_tum_layout()
    vis = run_vis()
    components = run_components()
    sweep = run_raysweep()
    run_scaling(dp_recs, spmd_recs, components, sweep, slam_metrics)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)

    # The kernels line: each kernel at the heaviest call of its path, the
    # mapping SDF sample (160,000 points) on bf16 quads (map_bf16 in
    # configs/Synthetic/room.yaml and in tracking; ``head`` above).  K1/K2
    # launches are the SLAM loop's, K3's the bench_scatter phase's.
    # The records each kernel was checked in (both point orders).
    checked = {"fwd": ("fwd", "fwd_rays"), "bwd": ("bwd", "bwd_rays"),
               "smem": ("smem", "smem_rays")}
    kernels = []
    for name, key, source, replaces, launches in (
            ("plane_sample_fwd", "fwd", "plane_sample.cu",
             "myslam_tpu/ops/pallas_sample.py:160",
             slam["launches"]["plane_sample_fwd"]),
            ("plane_sample_bwd", "bwd", "plane_sample.cu",
             "myslam_tpu/ops/plane_sample.py:343",
             slam["launches"]["plane_sample_bwd"]),
            ("plane_sample_fwd_smem", "smem", "plane_sample_smem.cu",
             "myslam_tpu/ops/pallas_sample.py:82 and :262",
             bench["launches"]["plane_sample_fwd_smem"])):
        rec = head[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"myslam_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c[k]["max_abs_err"] for c in cases
                               + [mesh_case, mesh["color_case"],
                                  vis["image_chunk"]["sdf"],
                                  vis["image_chunk"]["color"]]
                               for k in checked[key] if k in c),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            # On the loop's own ray-ordered points at the same sample; and
            # both orders' device time from a CUDA graph.
            "ms_rays": head[key + "_rays"]["ms"],
            "ms_graph": rec["ms_graph"],
            "ms_rays_graph": head[key + "_rays"]["ms_graph"]})
    # K1 at the meshing path's calls (one SDF volume chunk, one chunk of
    # vertex colors) and its launches in phase mesh.
    k1_mesh = mesh_case["fwd"]
    k1_colors = mesh["color_case"]["fwd"]
    kernels[0].update({
        "ms_mesh": k1_mesh["ms"], "ms_mesh_graph": k1_mesh["ms_graph"],
        "bound_ms_mesh": k1_mesh["bound_ms"],
        "plain_ms_mesh": k1_mesh["plain_ms"],
        "ms_mesh_colors": k1_colors["ms"],
        "ms_mesh_colors_graph": k1_colors["ms_graph"],
        "bound_ms_mesh_colors": k1_colors["bound_ms"],
        "plain_ms_mesh_colors": k1_colors["plain_ms"],
        "launches_mesh": mesh["launches"]["plane_sample_fwd"]})
    # K1 at the image renderer's call (phase vis: the SDF sample of one
    # chunk, 1,638,400 ray-ordered points, f32 quad) and its launches in
    # phase vis, the panels' included.
    k1_image = vis["image_chunk"]["sdf"]["fwd"]
    kernels[0].update({
        "ms_image": k1_image["ms"], "ms_image_graph": k1_image["ms_graph"],
        "bound_ms_image": k1_image["bound_ms"],
        "plain_ms_image": k1_image["plain_ms"],
        "library_ms_image": k1_image["library_ms"],
        "launches_vis": vis["launches"]["plane_sample_fwd"]})
    kernels[1]["launches_vis"] = vis["launches"]["plane_sample_bwd"]
    # K1 and K2 at the TUM schedule's mapping SDF sample (280,000 points,
    # bf16 quad) and their launches in phases slam_packed and
    # slam_host_staged; K1's in the host-staged run's mesh.
    tum_head = next(c for c in cases if c.get("config") == TUM_CONFIG
                    and c["layout"] == "sdf" and "fwd" in c)
    for k, key in ((kernels[0], "fwd"), (kernels[1], "bwd")):
        rec, rays = tum_head[key], tum_head[key + "_rays"]
        k.update({
            "ms_tum": rec["ms"], "ms_tum_graph": rec["ms_graph"],
            "ms_tum_rays": rays["ms"], "ms_tum_rays_graph": rays["ms_graph"],
            "bound_ms_tum": rec["bound_ms"], "plain_ms_tum": rec["plain_ms"],
            "library_ms_tum": rec["library_ms"],
            "launches_slam_packed": packed["launches"][k["name"]],
            "launches_slam_host_staged": host["launches"][k["name"]],
            "launches_host_evict": evict["runs"]["min"]["launches"][
                k["name"]],
            "launches_replica_layout": replica["runs"][0]["launches"][
                k["name"]],
            "launches_tum_layout": tum_layout["launches"][k["name"]]})
    kernels[0]["launches_mesh_host_staged"] = \
        host["finalize"]["launches"]["plane_sample_fwd"]
    # K1 and K2 launches per rank in the gang phases, and K2 at the
    # reduced pose system's call (coordinate gradient alone).
    for k in kernels[:2]:
        k.update({
            "launches_dp": [r["launches"][k["name"]] for r in dp_recs],
            "launches_kf_schur": [la[k["name"]] for la in kf["launches"]],
            "launches_kf_schur_pose_system": [
                la[k["name"]] for la in kf["schur_launches"]],
            "launches_kf_schur_every": [la[k["name"]]
                                        for la in kf_every["launches"]],
            "launches_kf_schur_every_pose_system": [
                la[k["name"]] for la in kf_every["schur_launches"]],
            "launches_gang_resume": [la[k["name"]]
                                     for la in resume["launches"]]})
    schur_k2 = schur_case["bwd_p_grad_only"]
    kernels[1].update({
        "max_abs_err": max(kernels[1]["max_abs_err"], schur_k2["max_abs_err"]),
        "ms_schur_p_grad_only": schur_k2["ms"],
        "plain_ms_schur_p_grad_only": schur_k2["plain_ms"],
        "bound_ms_schur_p_grad_only": schur_k2["bound_ms"]})
    # K1 and K2 launches per rank in the later gang phases.
    for k in kernels[:2]:
        k.update({f"launches_{name}": [la[k["name"]] for la in rec["launches"]]
                  for name, rec in (("pipeline", pipeline),
                                    ("map_shards", shards),
                                    ("kf_dp", kf_dp),
                                    ("dp_host_staged", dp_host))})
        k["launches_dp_spmd"] = [r["launches"][k["name"]]
                                 for r in spmd_recs]
    # The banded K1 / K2 (map shards): band 0's record at the mapping SDF
    # sample, both bands' ms, and their launches per rank in phase
    # map_shards (rank 0's as ``launches``).
    for name, key in (("plane_sample_fwd_banded", "fwd"),
                      ("plane_sample_bwd_banded", "bwd")):
        per = [b[key] for b in banded_case["per_band"]]
        errs = per + [b["bwd_no_quad_grad"] for b in banded_case["per_band"]
                      if key == "bwd"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "myslam_torch/csrc/plane_sample.cu",
            "replaces": "myslam_tpu/parallel/plane_shard.py:214",
            "launches": shards["launches"][0][name],
            "max_abs_err": max(p["max_abs_err"] for p in errs),
            "ms": per[0]["ms"], "plain_ms": per[0]["plain_ms"],
            "bound_ms": per[0]["bound_ms"], "bound_by": per[0]["bound_by"],
            "library_ms": None, "ms_graph": per[0]["ms_graph"],
            "ms_bands": [p["ms"] for p in per],
            "ms_graph_bands": [p["ms_graph"] for p in per],
            "bound_ms_bands": [p["bound_ms"] for p in per],
            "launches_map_shards": [la[name] for la in shards["launches"]]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
