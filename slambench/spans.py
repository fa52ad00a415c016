#!/usr/bin/env python3
"""The loop's own spans (``myslam_torch/utils/trace.py``) read on one
cell, apart from the result line.

    python3 slambench/spans.py --workload replica_dense --seed 7 \\
        --seconds 20 [--pairs 6 --pair-groups 4] [--rehearse]

One process, set up and warmed up as ``harness.run_cell`` does (the
loop's thread alone on one core from the window on), then:

  * the window: whole mapped groups for ``--seconds`` with the tracer on,
    in memory and not annotated, to a drain.  Its records give
    ``prefetch_wait_ms_per_frame`` and ``sync_ms_per_frame`` (those spans
    summed over the window's frames), ``track_iter_host_ms`` and
    ``map_iter_host_ms`` (the mean ``track.iter`` / ``map.iter``), the
    share of the loop thread's wall time from the first window frame to
    the drain that ``frame`` spans cover, and each span's self time;
  * the span phase: the traffic's ``trace_groups`` groups under a
    profiler of the host's operations and the device, the tracer
    annotated.  ``track_launches_per_iter`` / ``map_launches_per_iter``
    count the device operations (kernels, copies, fills) whose launching
    call lies under each ``track.iter`` / ``map.iter``, by the profiler's
    own links from an operation to the host call that launched it;
    ``idle_by_span`` puts each gap of the device's idle time down to the
    innermost span open on the loop's thread at the gap's middle; the
    offset is the median over the phase's spans of (profiler start -
    tracer start), with the largest deviation from it;
  * with ``--pairs N``: N pairs of blocks of ``--pair-groups`` groups,
    the tracer off in one block and on (not annotated) in the other,
    which goes first alternating: each block's frames/s, from its first
    frame's start to a drain, gives the tracer's cost when on.

It also times one ``span`` on the host, the tracer off and on.  The
last line of standard output is one JSON object; ``--rehearse`` runs
the cell cut to a tiny size on the CPU, where the device's numbers are
None ("not measured").
"""

from __future__ import annotations

import argparse
import bisect
import collections
import copy
import gc
import json
import os
import statistics
import sys
import time

# The checkout's root, in place of this file's folder (as run.py).
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from slambench import devtrace, harness  # noqa: E402

# Each iteration span and the spans inside it.
ITER_SPANS = {"track.iter": ("track.loss", "track.grad", "track.step"),
              "map.iter": ("map.loss", "map.backward", "map.step")}


def _dur_ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def window_metrics(records, t0_ns: int, t1_ns: int, last_ns: int,
                   frames: int) -> dict:
    """The window's span numbers (the module's docstring) from the
    tracer's records of spans that overlap ``t0_ns`` (the first frame's
    start) to ``t1_ns`` (the drain), over ``frames`` frames.  The loop's
    thread is the one that runs ``frame``.  The coverage ends at
    ``last_ns``, the last frame's start: that frame's span is still open
    at the drain."""
    recs = [r for r in records if r.end_ns > t0_ns and r.start_ns < t1_ns]
    loop = next((r.thread for r in recs if r.name == "frame"), None)
    recs = [r for r in recs if r.thread == loop]

    def total(name):
        return sum(_dur_ms(r) for r in recs if r.name == name)

    def mean(name):
        d = [_dur_ms(r) for r in recs if r.name == name]
        return statistics.fmean(d) if d else None

    child_ms: dict = {}
    for r in recs:
        if r.parent is not None:
            child_ms[r.parent] = child_ms.get(r.parent, 0.0) + _dur_ms(r)
    self_ms: dict = {}
    for r in recs:
        self_ms[r.name] = (self_ms.get(r.name, 0.0) + _dur_ms(r)
                           - child_ms.get(r.id, 0.0))
    counts: dict = {}
    for r in recs:
        counts[r.name] = counts.get(r.name, 0) + 1
    # The self time of an iteration's spans, per iteration.
    per_iter = {kind: {n: self_ms.get(n, 0.0) / counts[kind]
                       for n in (kind, *parts)}
                for kind, parts in ITER_SPANS.items() if counts.get(kind)}
    covered = 0
    for s, e in devtrace._merge([[r.start_ns, r.end_ns] for r in recs
                                 if r.name == "frame"]):
        covered += max(0, min(e, last_ns) - max(s, t0_ns))
    n = max(frames, 1)
    return {
        "prefetch_wait_ms_per_frame": total("prefetch_wait") / n,
        "sync_ms_per_frame": total("sync") / n,
        "track_iter_host_ms": mean("track.iter"),
        "map_iter_host_ms": mean("map.iter"),
        "frame_coverage": covered / max(last_ns - t0_ns, 1),
        "spans_per_frame": len(recs) / n,
        "span_counts": counts,
        "self_ms_per_frame": {k: v / n for k, v in sorted(
            self_ms.items(), key=lambda kv: -kv[1])},
        "self_ms_per_iter": per_iter,
    }


def _iteration_of(host, loop):
    """A function from a host event to the iteration span (an event of
    the loop's thread) its launches belong to: its enclosing iteration
    span; on the autograd engine's thread (a CUDA backward runs there),
    the one of the forward operation whose autograd sequence number the
    enclosing backward node carries.  None outside the iterations."""
    def up(e):
        while e is not None:
            if e.thread == loop and e.name in ITER_SPANS:
                return e
            if e.thread != loop and e.sequence_nr >= 0 \
                    and e.fwd_thread == loop:
                return forward.get(e.sequence_nr)
            e = e.cpu_parent
        return None

    forward = {}
    for e in host:
        if e.thread == loop and e.sequence_nr >= 0:
            forward.setdefault(e.sequence_nr, up(e))
    return up


def profile_metrics(events, records, t0_ns: int, t1_ns: int) -> dict:
    """The span phase's numbers (the module's docstring) from a stopped
    profiler's ``events()`` and the tracer's records of the spans that
    opened and closed between ``t0_ns`` and ``t1_ns``."""
    import torch

    records = [r for r in records
               if t0_ns <= r.start_ns and r.end_ns <= t1_ns]
    names = {r.name for r in records}
    cuda = torch.autograd.DeviceType.CUDA
    spans = [e for e in events if e.device_type != cuda and e.name in names]
    loop = next((e.thread for e in spans if e.name == "frame"), None)
    spans = [e for e in spans if e.thread == loop]
    dev = [e for e in events if e.device_type == cuda]
    notes = {e.name for e in dev if devtrace._annotation(e)} | set(names)
    work = [[float(e.time_range.start), float(e.time_range.end)]
            for e in dev if e.name not in notes
            and e.time_range.end > e.time_range.start]
    # Every device operation is linked to one host call, once.
    out: dict = {"device_ops": len(work), "linked_ops": sum(
        1 for e in events if e.device_type != cuda
        for k in e.kernels if k.name not in notes)}
    # Launches: the device operations the profiler links to a host call
    # under each iteration span (or to a backward node of its operations).
    host = [e for e in events if e.device_type != cuda]
    iteration = _iteration_of(host, loop)
    per = {id(e): [] for e in spans if e.name in ITER_SPANS}
    for e in host:
        names = [k.name for k in e.kernels if k.name not in notes]
        it = iteration(e) if names else None
        if it is not None:
            per[id(it)] += names
    out["iter_ops"] = sum(len(v) for v in per.values())
    for kind in ITER_SPANS:
        ops = [per[id(e)] for e in spans if e.name == kind]
        counts = [len(v) for v in ops]
        out[kind.replace(".iter", "") + "_launches_per_iter"] = (
            statistics.fmean(counts) if counts and dev else None)
        # How many iterations launched how many; and what an iteration
        # launched beyond the commonest count, the first of each count.
        hist = collections.Counter(counts)
        out[kind + ".launches"] = {str(n): c for n, c in sorted(hist.items())}
        if hist:
            mode = hist.most_common(1)[0][0]
            base = collections.Counter(ops[counts.index(mode)])
            out[kind + ".beyond_mode"] = {
                str(n): sorted((collections.Counter(ops[counts.index(n)])
                                - base).elements())[:8]
                for n in hist if n != mode}
    # The device's idle gaps by the innermost span open at their middle.
    merged = devtrace._merge(work)
    spans.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in spans]
    idle: dict = {}
    for (_, e0), (s1, _) in zip(merged[:-1], merged[1:]):
        mid = 0.5 * (e0 + s1)
        name = "(no span)"
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if spans[k].time_range.end >= mid:
                name = spans[k].name
                break
        idle[name] = idle.get(name, 0.0) + (s1 - e0) / 1e6
    total = sum(idle.values())
    out["idle_s"] = total if dev else None
    out["idle_by_span"] = sorted(([n, v] for n, v in idle.items()),
                                 key=lambda kv: -kv[1])[:10]
    out["idle_below_frame_share"] = (
        sum(v for n, v in idle.items() if n not in ("frame", "(no span)"))
        / total if total else None)
    # The tracer's clock against the profiler's, span by span: a rough
    # offset from the names whose spans the two count alike, then each
    # record against its name's event nearest to it.
    by_name: dict = {}
    for e in spans:
        by_name.setdefault(e.name, []).append(1e3 * e.time_range.start)
    rough = []
    for name, ev in by_name.items():
        mine = sorted(r.start_ns for r in records if r.name == name)
        if len(mine) == len(ev):
            rough += [b - a for a, b in zip(mine, ev)]
    if not rough:
        out["offset_ns"] = None
        return out
    rough = statistics.median(rough)
    diffs = []
    for r in records:
        ev = by_name.get(r.name, [])
        k = bisect.bisect_left(ev, r.start_ns + rough)
        near = [ev[j] for j in (k - 1, k) if 0 <= j < len(ev)]
        if near:
            diffs.append((min((b - r.start_ns for b in near),
                              key=lambda d: abs(d - rough)), r.name))
    mid = statistics.median(d for d, _ in diffs)
    dev_ns = sorted(abs(d[0] - mid) for d in diffs)
    out.update(offset_ns=mid, offset_max_dev_us=dev_ns[-1] / 1e3,
               offset_p99_dev_us=dev_ns[int(0.99 * (len(dev_ns) - 1))] / 1e3,
               offset_spans=len(diffs),
               # Signed: positive where the profiler stamped late.
               offset_over_100us=[[n, (d - mid) / 1e3] for d, n in diffs
                                  if abs(d - mid) > 1e5])
    return out


def span_cost_ns(trace, on: bool, n: int = 200_000) -> float:
    """Host nanoseconds of one ``with span(...)``, the tracer ``on``
    (not annotated, its records dropped) or off."""
    if on:
        trace.enable()
    span = trace.span
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("sync"):
            pass
    t1 = time.perf_counter_ns()
    trace.disable()
    trace.take()
    return (t1 - t0) / n


def run(workload: str, seed: int, seconds: float, pairs: int,
        pair_groups: int, rehearse: bool) -> dict:
    import torch

    from myslam_torch.engine import scheduler
    from myslam_torch.utils import trace

    from slambench import record
    from slambench.frames import FrameSource

    torch.set_num_threads(1)
    cell = harness.load_cell(workload)
    traffic = cell["traffic"]
    cfg = copy.deepcopy(cell["config"])
    if rehearse:
        cfg = harness.rehearsal_config(cfg)
    device = torch.device("cpu" if rehearse else "cuda")
    cuda = device.type == "cuda"
    plan = harness.window_plan(cfg, traffic, seed)
    first, every, n = plan["first"], plan["every"], plan["n"]
    tg = int(traffic["trace_groups"])
    cfg["data"]["n_frames"] = n
    source = FrameSource(cfg, traffic, seed, n, device)
    prefetchers = record.Prefetchers(scheduler)
    mask = os.sched_getaffinity(0)
    core = max(mask)
    # The phases after the warm-up: (name, groups, tracer), the window's
    # groups set by the clock.
    phases = [("window", None, "on"), ("spans", tg, "annotate")]
    for k in range(pairs):
        order = ("off", "on") if k % 2 == 0 else ("on", "off")
        phases += [(f"pair{k}.{m}", pair_groups, m) for m in order]
    st: dict = {"k": -1, "done": [], "gc_ns": 0}

    def gc_clock(phase, info):
        if phase == "start":
            st["gc0"] = time.perf_counter_ns()
        elif "gc0" in st:
            st["gc_ns"] += time.perf_counter_ns() - st.pop("gc0")
    out: dict = {"workload": workload, "seed": seed, "cuda": cuda}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def begin(s, idx):
        st["k"] += 1
        name, groups, mode = phases[st["k"]]
        sync()
        st.update(start=idx, end=None if groups is None
                  else idx + groups * every, mode=mode)
        if mode == "annotate":
            st["prof"] = devtrace.start_profiler(cuda, host=True)
        if mode != "off":
            trace.enable(annotate=mode == "annotate")
        isolate()
        st.update(gc_ns=0, cpu0=time.thread_time())
        st["t0"] = time.perf_counter_ns()

    def isolate():
        if not rehearse:
            harness.isolate(core, mask)

    def finish(s, idx):
        sync()
        t1 = time.perf_counter_ns()
        name, _, mode = phases[st["k"]]
        trace.disable()
        frames = idx - st["start"]
        # A block's frames/s counts from its first frame's start.
        t_first = s.frame_start_wall[st["start"] + 1]
        log = s.frame_log[st["start"] + 1:idx + 1]
        row = {"phase": name, "mode": mode, "frames": frames,
               "frames_per_s": frames / (t1 / 1e9 - t_first),
               # The loop's own per-frame times and the loop thread's
               # CPU and garbage-collection time, tracer on or off.
               "track_ms_per_frame": sum(
                   r.get("track_ms", 0.0) for r in log) / max(frames, 1),
               "map_ms_per_frame": sum(
                   r.get("map_ms", 0.0) for r in log) / max(frames, 1),
               "loop_cpu_s": time.thread_time() - st["cpu0"],
               "gc_ms": st["gc_ns"] / 1e6}
        if mode == "annotate":
            st["prof"].stop()
            row.update(profile_metrics(st["prof"].events(), trace.take(),
                                       st["t0"], t1))
        elif mode == "on":
            row.update(window_metrics(
                trace.take(), int(t_first * 1e9), t1,
                int(s.frame_start_wall[idx] * 1e9), frames))
        st["done"].append(row)

    def on_map_done(s, idx):
        if st["k"] < 0:
            if idx == first - 1:
                begin(s, idx)
            return
        now = time.perf_counter_ns()
        end = st["end"]
        if end is None:
            t_first = s.frame_start_wall[st["start"] + 1]
            if now / 1e9 - t_first < seconds and idx < plan["last"]:
                return
        elif idx < end:
            return
        finish(s, idx)
        if st["k"] + 1 == len(phases) or idx + 2 * every >= n:
            raise harness.StopRun
        begin(s, idx)

    try:
        slam = scheduler.SLAMSystem(
            cfg, output=os.path.join(harness.ROOT, "build", "slambench",
                                     workload + "_spans"),
            seed=seed, device=device)
        slam.dataset = source
        slam.sync_after_frame = first - 1
        if cuda:
            # The profiler's own start-up (CUPTI) belongs to set-up.
            devtrace.start_profiler(cuda, host=True).stop()
        slam.on_map_done = on_map_done
        gc.callbacks.append(gc_clock)
        try:
            slam.run_loop()
        except harness.StopRun:
            pass
    finally:
        if gc_clock in gc.callbacks:
            gc.callbacks.remove(gc_clock)
        trace.disable()
        harness.release(mask)
        source.close()
        prefetchers.end()
        prefetchers.restore()
    out["phases"] = st["done"]
    out["span_off_ns"] = span_cost_ns(trace, False)
    out["span_on_ns"] = span_cost_ns(trace, True)
    out["device"] = torch.cuda.get_device_name(0) if cuda else "cpu"
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--pairs", type=int, default=0)
    p.add_argument("--pair-groups", type=int, default=4)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    harness.cache_env()
    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("slambench: spans needs a CUDA device", file=sys.stderr)
        return 3
    out = run(args.workload, args.seed, args.seconds, args.pairs,
              args.pair_groups, args.rehearse)
    for row in out["phases"]:
        brief = {k: v for k, v in row.items()
                 if k not in ("self_ms_per_frame", "span_counts")}
        print(f"slambench.spans: {json.dumps(brief)}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
