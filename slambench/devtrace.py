"""The device trace of a run's traced sub-window, reduced to numbers.

``torch.profiler`` runs over whole mapped groups after the window, first
over the device's activity alone (its busy time and operations: the
host's operations, traced, slow the host and so lengthen the idle gaps),
then over the host's operations too (the kernels' times, the idle gaps'
names).  From a trace's events:

  * ``busy_s``: the union of the intervals in which a device operation
    (a kernel, a copy, a fill) ran, and ``window_s`` the sub-window's
    length on the host's clock;
  * ``kernel_ms``: device milliseconds by kernel family (K1, K2);
  * ``device_ops``: the 10 device operations that took most time;
  * ``idle_gaps``: the device's idle time, gap by gap named by what the
    host was doing at the gap's middle (the benchmark's span around the
    call into the program, then the outermost host operation running),
    summed by name, the 10 largest.
"""

from __future__ import annotations

import bisect

import torch

# Kernel families by a part of their symbol's name.
KERNELS = {"k1": "plane_sample_fwd_kernel", "k2": "plane_sample_bwd_kernel"}


def start_profiler(cuda: bool, host: bool = True):
    """A started profiler of the device's activity (``cuda``) and, with
    ``host`` (or without a device), of the host's operations."""
    acts = []
    if host or not cuda:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, record_shapes=False,
                                  profile_memory=False, with_stack=False)
    prof.start()
    return prof


def _annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or (
        e.name.startswith(("slambench.", "Optimizer.", "ProfilerStep"))
        or "#" in e.name)


def _merge(iv: list) -> list:
    iv.sort()
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(prof, window_s: float) -> dict:
    """The numbers of the module's docstring from a stopped profiler."""
    dev, host, spans = [], [], []
    by_name: dict = {}
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # Spans (the benchmark's, the optimizer's) are mirrored onto
            # the device's timeline as annotations: they are no work.
            if t > s and not _annotation(e):
                dev.append((s, t))
                by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
        elif e.name.startswith("slambench."):
            spans.append((s, t, e.name[len("slambench."):], e.thread))
        elif e.cpu_parent is None or e.cpu_parent.name.startswith(
                "slambench."):
            host.append((s, t, e.name, e.thread))
    # The loop's thread is the one that runs the benchmark's spans; the
    # prefetch thread's operations do not name a gap.
    main = spans[0][3] if spans else None
    host = [h for h in host if main is None or h[3] == main]
    merged = _merge([list(x) for x in dev])
    busy_us = sum(e - s for s, e in merged)
    kernel_ms = {k: sum(v for n, v in by_name.items() if part in n) / 1e3
                 for k, part in KERNELS.items()}
    host.sort()
    spans.sort()
    h_starts = [h[0] for h in host]
    s_starts = [s[0] for s in spans]

    def covering(starts, items, mid):
        k = bisect.bisect_right(starts, mid) - 1
        while k >= 0 and k >= bisect.bisect_right(starts, mid) - 64:
            if items[k][1] >= mid:
                return items[k][2]
            k -= 1
        return None

    gaps: dict = {}
    for (_, e0), (s1, _) in zip(merged[:-1], merged[1:]):
        mid = 0.5 * (e0 + s1)
        name = (f"{covering(s_starts, spans, mid) or 'loop'}/"
                f"{covering(h_starts, host, mid) or 'python'}")
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": float(window_s),
        "kernel_ms": kernel_ms,
        "device_ops": [[n[:120], v / 1e6] for n, v in top_ops],
        "idle_gaps": sorted([[n[:120], v] for n, v in gaps.items()],
                            key=lambda kv: -kv[1])[:10],
    }
