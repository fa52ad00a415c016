"""Timing helpers of the port's profiling tools.

On a CUDA device a call's time is taken with CUDA events around a run of
calls, after a synchronize; ``profile_calls`` also traces the same run
with ``torch.profiler`` and sums its device events.  On the CPU (the
tools' ``--device cpu``, for rehearsal) times come from the host clock
and there is no device time: ``profile_calls`` gives None.
"""

from __future__ import annotations

import time

import torch

# Device events that are copies or fills, not kernel launches.
_COPIES = ("Memcpy", "Memset")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device: torch.device, calls: int, warmup: int = 1) -> float:
    """Milliseconds per call of fn() over ``calls`` calls made one after
    another, after ``warmup`` calls and a synchronize: CUDA events on a
    CUDA device, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3 / calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / calls


def profile_calls(fn, device: torch.device, calls: int) -> dict:
    """Per call of fn() over ``calls`` calls traced by torch.profiler:
    ``device_ms``, the device time of its kernels and copies, and
    ``launches``, its kernel launches.  Both None on the CPU."""
    if device.type != "cuda":
        return {"device_ms": None, "launches": None}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync(device)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    busy_us = sum(e.device_time_total for e in events)
    kernels = sum(not e.name.startswith(_COPIES) for e in events)
    return {"device_ms": busy_us / 1e3 / calls, "launches": kernels / calls}
