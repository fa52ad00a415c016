"""One run of one cell: set-up, warm-up, the measured window, the traced
sub-window, the check, and the result line.

The entry the window drives is ``myslam_torch.engine.scheduler.SLAMSystem
.run_loop`` on the cell's configuration, with the benchmark's frame
source (``frames.py``) in place of the procedural reader.  The loop is
stopped from outside through its ``on_map_done`` hook, which runs after
each mapped frame:

  * warm-up (``setup_s``): frame 0's ``iters_first`` iterations, then
    whole groups up to frame ``warmup_frames - 1``, a mapped frame by
    which joint optimisation has run (and, with holes, the importance
    branch from frame 0); the loop drains the device there
    (``sync_after_frame``);
  * the window: whole mapped groups from frame ``warmup_frames`` until
    ``seconds`` have passed at the end of a group (or the sequence of
    ``sequence_frames`` has no more groups than the ones that follow the
    window), then a drain; the loop's thread has one core to itself for
    it, every other thread of the process the others;
  * with ``trace``: ``trace_groups`` more groups under a profiler of the
    device's activity alone (the device's busy time and operations), then
    ``trace_groups`` more under one of the host's operations too, with
    K1's and K2's calls recorded (the kernels' times and the idle gaps
    named by what the host was doing);
  * then the hook raises ``StopRun``, the frame source is closed and the
    prefetch thread ended, the device's peak memory having been read at
    the window's end, the program's state is freed and the reference
    follows the recorded group (``check.py``).
"""

from __future__ import annotations

import copy
import gc
import json
import os
import sys
import threading
import time

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# Whole top-level module names the run may not hold once its window has
# closed: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "myslam_tpu")
# K1 and K2, the loop's sample kernels, by their LAUNCHES keys.
SAMPLE_LAUNCHES = ("plane_sample_fwd", "plane_sample_bwd")
# Store slots whose imagery the check compares.
STORE_SLOTS = 4


class StopRun(Exception):
    """Raised from the loop's hook once the run has what it needs."""


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the kernels' library is the program's own ``build/kernels``)."""
    cache = os.path.join(ROOT, "build", "cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    # One process with few threads: no CPU thread pool spinning beside
    # the loop's host thread.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def load_cell(workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics, by
    the names in BENCHMARK.json."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(BENCH, "limits", workload + ".json")) as f:
        limits = json.load(f)

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"cell": cell, "config": config["config"], "traffic": traffic,
            "limits": limits["limits"],
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def rehearsal_config(cfg: dict) -> dict:
    """The configuration cut to a size the CPU runs in seconds: a 32
    pixel wide camera, few rays, up to 24 tracking and 3 mapping
    iterations (enough for Adam's steps to show the control); every path
    of the cell kept."""
    cfg = copy.deepcopy(cfg)
    cam = cfg["cam"]
    s = 32.0 / cam["W"]
    cam.update(W=32, H=int(round(cam["H"] * s)), fx=cam["fx"] * s,
               fy=cam["fy"] * s)
    cam.update(cx=(cam["W"] - 1) / 2.0, cy=(cam["H"] - 1) / 2.0)
    t, m = cfg["tracking"], cfg["mapping"]
    t.update(pixels=64, iters=min(int(t["iters"]), 24), ignore_edge_W=2,
             ignore_edge_H=2)
    m.update(pixels=128, iters=min(int(m["iters"]), 3), iters_first=5)
    return cfg


def window_plan(cfg: dict, traffic: dict, seed: int) -> dict:
    """The first window frame, the checked group's mapped frame, the last
    mapped frame at which the window may close (the traced groups and one
    spare follow it before the sequence's last frame) and the sequence
    length; checks that the warm-up ends on a mapped frame after joint
    optimisation has run."""
    m = cfg["mapping"]
    ef, ke = int(m["every_frame"]), int(m["keyframe_every"])
    first = int(traffic["warmup_frames"])
    if (first - 1) % ef:
        raise ValueError(f"warm-up frame {first - 1} is not a mapped frame")
    admitted = sum(1 for f in range(0, first - 1, ef) if f % ke == 0)
    if admitted <= 4:
        raise ValueError("the warm-up ends before joint optimisation runs")
    g = int(np.random.default_rng([int(seed), 1]).integers(
        int(traffic["check_groups"])))
    n = int(traffic["sequence_frames"])
    after = ef * (2 * int(traffic["trace_groups"]) + 1)
    last = first - 1 + (n - 2 - after - (first - 1)) // ef * ef
    check = first - 1 + (g + 1) * ef
    if check > last:
        raise ValueError("the sequence is too short for the window")
    return {"first": first, "check_frame": check, "last": last, "n": n,
            "every": ef}


def isolate(core: int, mask: set) -> None:
    """The calling (the loop's) thread on ``core`` alone, every other
    thread of the process on the rest of ``mask``, so that no thread of
    the run takes the loop's core.  Called again, it moves the threads
    made since."""
    rest = (set(mask) - {core}) or set(mask)
    me = threading.get_native_id()
    for name in os.listdir("/proc/self/task"):
        if int(name) != me:
            try:
                os.sched_setaffinity(int(name), rest)
            except OSError:
                pass
    os.sched_setaffinity(0, {core})


def release(mask: set) -> None:
    """Every thread of the process back on ``mask``."""
    for name in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(name), mask)
        except OSError:
            pass


def host_sample() -> dict:
    """The calling thread's and the process's CPU seconds at one moment,
    on the host's clock."""
    return {"wall": time.perf_counter(), "thread": time.thread_time(),
            "process": time.process_time()}


def host_figures(a: dict, b: dict, core: int) -> dict:
    """The window's host figures from two ``host_sample``s taken in the
    loop's thread: the window's seconds, the loop thread's and the whole
    process's CPU seconds in it, and the loop's core."""
    return {"wall_s": b["wall"] - a["wall"],
            "loop_cpu_s": b["thread"] - a["thread"],
            "process_cpu_s": b["process"] - a["process"], "core": core}


def kernel_buffer_points(cfg: dict, traffic: dict) -> int:
    """Sample points of K1's calls in the traced groups (the buffer that
    keeps them), with room to spare."""
    r, t, m = cfg["rendering"], cfg["tracking"], cfg["mapping"]
    s = int(r["n_stratified"]) + int(r["n_importance"])
    per_group = (int(m["every_frame"]) * int(t["iters"]) * 2 * int(
        t["pixels"]) * s + int(m["iters"]) * (2 * int(m["pixels"]) * s + int(
            m["pixels"]) * int(r["n_stratified"])))
    return int(1.1 * per_group * int(traffic["trace_groups"])) + 1


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             rehearse: bool = False, control: bool = False,
             t_start: float | None = None) -> dict:
    """One run; returns the result line's fields (see the module's
    docstring).  ``control``: the program's own bfloat16 map reads
    switched on (the control of the check)."""
    import torch

    from myslam_torch.engine import mapper, scheduler
    from myslam_torch.ops import cuda_sample

    from slambench import check, counts, record
    from slambench import devtrace as tracing
    from slambench.frames import FrameSource

    torch.set_num_threads(1)
    t_start = time.time() if t_start is None else t_start
    # Host wall time (time.time) of the loop's perf_counter readings.
    clock = time.time() - time.perf_counter()
    cell = load_cell(workload)
    traffic = cell["traffic"]
    cfg = copy.deepcopy(cell["config"])
    if rehearse:
        cfg = rehearsal_config(cfg)
    if control:
        cfg["tracking"]["map_bf16"] = True
        cfg["mapping"]["map_bf16"] = True
    device = torch.device("cpu" if rehearse else "cuda")
    cuda = device.type == "cuda"
    plan = window_plan(cfg, traffic, seed)
    first, every = plan["first"], plan["every"]
    cfg["data"]["n_frames"] = plan["n"]
    out_dir = os.path.join(ROOT, "build", "slambench", workload)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    source = FrameSource(cfg, traffic, seed, plan["n"], device)
    prefetchers = record.Prefetchers(scheduler)
    kcalls = recorder = None
    mask = os.sched_getaffinity(0)
    core = max(mask)
    tg = int(traffic["trace_groups"])
    try:
        slam = scheduler.SLAMSystem(cfg, output=out_dir, seed=seed,
                                    device=device)
        slam.dataset = source
        if slam.n_img != len(source):
            raise ValueError("the frame source and the loop disagree on "
                             "the sequence length")
        init = record.clone_map(slam.map_state,
                                lambda t: t.detach().to("cpu", copy=True))
        recorder = record.StepRecorder(slam, plan["check_frame"], every,
                                       mapper)
        slam.sync_after_frame = first - 1
        if trace and cuda:
            # The profilers' own start-up (CUPTI) belongs to set-up.
            tracing.start_profiler(cuda, host=False).stop()
            tracing.start_profiler(cuda, host=True).stop()
        st: dict = {"phase": "warmup"}

        def sync():
            if cuda:
                torch.cuda.synchronize()

        def on_map_done(s, idx):
            nonlocal kcalls
            if st["phase"] == "warmup":
                if idx == first - 1:
                    st.update(phase="window", launches0=sum(
                        cuda_sample.LAUNCHES[k] for k in SAMPLE_LAUNCHES))
                    # The loop's thread has one core to itself through the
                    # window: the prefetch and CUDA runtime threads keep
                    # the rest (PERF.md).
                    isolate(core, mask)
                    st["host0"] = host_sample()
                return
            now = time.perf_counter()
            if st["phase"] == "window":
                if idx < plan["check_frame"] or (
                        now - s.frame_start_wall[first] < seconds
                        and idx < plan["last"]):
                    return
                sync()
                st.update(t_end=time.perf_counter(), last=idx,
                          host1=host_sample(),
                          launches1=sum(cuda_sample.LAUNCHES[k]
                                        for k in SAMPLE_LAUNCHES),
                          mem=(torch.cuda.max_memory_allocated()
                               if cuda else None))
                if not trace:
                    raise StopRun
                st.update(phase="trace_dev", trace_end=idx + tg * every,
                          prof_dev=tracing.start_profiler(cuda, host=False))
                isolate(core, mask)
                st["t_dev0"] = time.perf_counter()
                return
            if st["phase"] == "trace_dev" and idx >= st["trace_end"]:
                sync()
                st["t_dev1"] = time.perf_counter()
                st["prof_dev"].stop()
                st["dev_end"] = idx
                kcalls = record.KernelCalls(
                    cuda_sample, kernel_buffer_points(cfg, traffic), device)
                st.update(phase="trace_host", trace_end=idx + tg * every,
                          prof=tracing.start_profiler(cuda, host=True))
                isolate(core, mask)
                kcalls.active = True
                st["t_tr0"] = time.perf_counter()
                return
            if st["phase"] == "trace_host" and idx >= st["trace_end"]:
                sync()
                st["t_tr1"] = time.perf_counter()
                kcalls.active = False
                st["prof"].stop()
                raise StopRun

        slam.on_map_done = on_map_done
        try:
            slam.run_loop()
        except StopRun:
            pass
        else:
            raise RuntimeError("the sequence ended before the run's last "
                               "traced group")
        finally:
            release(mask)
            source.close()
            prefetchers.end()
        stop = st.get("trace_end", st["last"])
        log = slam.frame_log
        win = log[first:st["last"] + 1]
        window_s = st["t_end"] - slam.frame_start_wall[first]
        failed = 0
        for r in win:
            vals = [r[k] for k in ("track_loss_best", "map_loss") if k in r]
            if vals and not bool(torch.stack([torch.as_tensor(v).reshape(())
                                              for v in vals])
                                 .isfinite().all()):
                failed += 1
        ops = 0
        for r in win:
            ops += int(cfg["tracking"]["iters"]) * counts.iteration_ops(
                cfg, "track")
            if "map_iters" in r:
                ops += r["map_iters"] * counts.iteration_ops(
                    cfg, "map", bool(r["map_importance"]))
        store = slam.store
        rng = np.random.default_rng([int(seed), 2])
        slots = sorted(set(rng.integers(0, store.count, STORE_SLOTS)
                           .tolist()))
        if store.packed:
            got = {s: (store.colors[s].cpu(), store.depths_u16[s].cpu(),
                       store.depth_inv_q[s:s + 1].cpu()) for s in slots}
        else:
            got = {s: (store.colors[s].cpu(), store.depths[s].cpu())
                   for s in slots}
        est = slam.est[1:stop + 1].cpu().numpy()
        gt = slam.gt_poses[1:stop + 1]
        ate_cm = float(np.sqrt(np.mean(np.sum(
            (est[:, :3, 3] - gt[:, :3, 3]) ** 2, -1))) * 100)
        run = {
            "frames": len(win), "window_s": window_s,
            "setup_s": slam.frame_start_wall[first] + clock - t_start,
            "frame0_s": log[0]["map_ms"] / 1e3,
            "track_ms": [r["track_ms"] for r in win if "track_ms" in r],
            "map_ms": [r["map_ms"] for r in win if "map_ms" in r],
            "launches": st["launches1"] - st["launches0"],
            "ops": ops, "memory_peak_bytes": st["mem"],
            "source_ms_per_frame": 1e3 * source.cpu_seconds / max(
                source.calls, 1),
            "source_wall_ms_per_frame": 1e3 * source.seconds / max(
                source.calls, 1),
            "frame_ms": [r.get("frame_ms") for r in win],
            "hole_share": (float(np.mean(source.hole_share))
                           if source.hole_share else 0.0),
            "ate_cm": ate_cm, "failed": failed, "trace": None,
            "bounds": None, "cuda": cuda,
            "host": host_figures(st["host0"], st["host1"], core),
        }
        if trace:
            dev = tracing.reduce(st["prof_dev"], st["t_dev1"] - st["t_dev0"])
            host = tracing.reduce(st["prof"], st["t_tr1"] - st["t_tr0"])
            # The device's busy time and operations from the trace of the
            # device's activity alone; the kernels' times and the idle
            # gaps' names from the one of the host's operations too.
            run["trace"] = {**dev, "kernel_ms": host["kernel_ms"],
                            "idle_gaps": host["idle_gaps"]}
            run["bounds"] = kcalls.bounds()
            run["trace_frames_per_s"] = {
                "device": (st["dev_end"] - st["last"])
                / (st["t_dev1"] - st["t_dev0"]),
                "host": (st["trace_end"] - st["dev_end"])
                / (st["t_tr1"] - st["t_tr0"])}
        checked = {"track": recorder.track, "map": recorder.map,
                   "init": init, "store": got, "store_upto": stop + 1,
                   "n_img": slam.n_img}
        if checked["track"] is None or checked["map"] is None:
            raise RuntimeError("the checked group was not recorded")
        recorder.slam = None
        del slam, store, st
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    finally:
        release(mask)
        prefetchers.restore()
        if recorder is not None:
            recorder.restore()
        if kcalls is not None:
            kcalls.restore()
    t0 = time.perf_counter()
    numbers = check.compare(cfg, seed, checked, source, device)
    run["check_s"] = time.perf_counter() - t0
    # A cell compares the numbers its limits file names; the others are
    # reported beside them.
    run["compared"] = {k: {"value": v, "limit": cell["limits"][k]}
                       for k, v in numbers.items() if k in cell["limits"]}
    run["not_compared"] = {k: v for k, v in numbers.items()
                           if k not in cell["limits"]}
    run["correct"] = all(v["value"] <= v["limit"]
                         for v in run["compared"].values())
    return {"run": run, "cell": cell}


def metric_line(workload: str, result: dict, trace: bool) -> dict:
    """The contract's result line from a run: the cell's end-to-end
    metrics (``trace`` false) or its per-layer metrics, each read by its
    file under metrics/ (per-layer) or here (end-to-end)."""
    import importlib

    import torch

    run, cell = result["run"], result["cell"]
    metrics = {}
    run["left_out"] = []
    if not trace:
        e2e = {"frames_per_s": run["frames"] / run["window_s"],
               "setup_s": run["setup_s"]}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell["per_layer"]:
            mod = importlib.import_module(f"slambench.metrics.{m['name']}")
            v = mod.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            elif not run["cuda"]:
                metrics[m["name"]] = {"value": None, "unit": m["unit"],
                                      "note": "not measured"}
            else:
                # Its reader found nothing to read: left out of the line,
                # and named on standard error.
                run["left_out"].append(m["name"])
    if run["cuda"]:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": int(cell["cell"]["chips"]),
                  "memory_peak_bytes": int(run["memory_peak_bytes"])}
    else:
        device = {"platform": "cpu", "kind": "not measured", "count": 0,
                  "memory_peak_bytes": None}
    line = {"correct": bool(run["correct"]), "attempted": run["frames"],
            "failed": run["failed"], "metrics": metrics, "device": device}
    if trace and run["trace"] is not None:
        tr = run["trace"]
        if run["cuda"]:
            device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
            line["breakdown"] = {"device_ops": tr["device_ops"],
                                 "idle_gaps": tr["idle_gaps"]}
        else:
            device.update(busy_s=None, window_s=tr["window_s"])
    line["compared"] = run["compared"]
    return line


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
