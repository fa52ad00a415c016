"""Spans of the SLAM loop's host work, kept in memory.

``span(name, frame=None)`` is a context manager around a stretch of the
loop's host time.  The tracer is off by default: ``span`` then returns
one shared object that does nothing, after a single flag check, so a
run that does not trace keeps no record and opens no profiler
annotation.  ``enable()`` turns it on.  Each span then appends a
``Record`` when it closes: its name, its start and end on
``time.perf_counter_ns()`` (the clock of ``SLAMSystem.frame_start_wall``
and ``drain_wall``), the enclosing span on the same thread, the frame
index (given, or the enclosing span's) and the thread.  ``take()``
returns the records and clears them; nothing is written to disk.  With
``enable(annotate=True)`` every span also opens a
``torch.profiler.record_function`` of its name, so that under a profiler
the spans are on the device trace's clock and are the parents of the
operations launched inside them.

The loop's spans (``engine/scheduler.py``, ``engine/tracker.py``,
``engine/mapper.py``, ``render/renderer.py``, ``utils/datasets.py``), on
the loop's thread:

  * ``frame`` (the frame's index): the body of ``run_loop``'s iteration;
  * ``prefetch_wait``: the loop's wait for its next packet
    (``PacketPrefetcher``);
  * ``sync``: every wait of the loop on the device (the drains around a
    tracked group and a mapped frame, ``sync_after_frame``, the final
    drain, the metrics' read-back, the host-staged window's fetch);
  * ``track.group`` (its first frame) holding ``track.pack`` and, per
    frame and iteration, ``track.iter``: with ``track.loss``,
    ``track.grad`` and ``track.step`` on the tracker's eager path, the
    launch of one graph replay on its replayed path; ``track.capture``
    around the replayed path's capture;
  * ``map.frame`` (the mapped frame) holding ``map.select``, per
    iteration ``map.iter``: with ``map.loss``, ``map.backward`` and
    ``map.step`` on the mapper's eager path, the launch of one graph
    replay and ``map.step`` on its replayed path; ``map.capture`` around
    the replayed path's capture; then ``map.writeback``;
  * ``render.importance`` (``render/renderer.py``): the importance
    branch's coarse SDF pass, ``sample_pdf`` and the sort, under the
    caller's span (``map.loss`` on mapping's path);
  * ``post_map``: the periodic checkpoint and mesh.

``write_chrome_trace`` writes records as a Chrome trace (``run_torch.py
--spans``).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int | None  # the enclosing span's id on the same thread
    frame: int | None
    thread: int  # threading.get_native_id()
    id: int


class _Thread(threading.local):
    """Each thread's open spans and its id."""

    def __init__(self):
        self.stack: list = []
        self.tid = threading.get_native_id()


_on = False
_annotate = False
# Closed spans as plain tuples in ``Record``'s order (``take`` names them).
_records: list[tuple] = []
_ids = itertools.count()
_thread = _Thread()


class _Off:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "frame", "id", "parent", "start", "annotation")

    def __init__(self, name: str, frame: int | None):
        self.name = name
        self.frame = frame

    def __enter__(self):
        stack = _thread.stack
        if stack:
            parent = stack[-1]
            self.parent = parent.id
            if self.frame is None:
                self.frame = parent.frame
        else:
            self.parent = None
        self.id = next(_ids)
        stack.append(self)
        # Both stamps come right before the annotation's calls, whose
        # return may wait for the interpreter lock after the profiler has
        # stamped.
        self.annotation = (torch.profiler.record_function(self.name)
                           if _annotate else None)
        self.start = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        th = _thread
        th.stack.pop()
        _records.append((self.name, self.start, end, self.parent,
                         self.frame, th.tid, self.id))
        return False


def span(name: str, frame: int | None = None):
    """A span of host time named ``name``; ``frame``: the frame it
    belongs to (default: the enclosing span's)."""
    if not _on:
        return _OFF
    return _Span(name, frame)


def enable(annotate: bool = False) -> None:
    """Keep a record of every span from now on; ``annotate``: also open
    a ``torch.profiler.record_function`` per span.  Enabled under a
    profiler, annotation first opens and closes one ``trace.enable``
    range: a process's first annotation under a profiler takes ~1.5 ms
    of start-up, which would otherwise part the first span's start on
    the profiler's clock from the tracer's."""
    global _on, _annotate
    if annotate:
        with torch.profiler.record_function("trace.enable"):
            pass
    _annotate = bool(annotate)
    _on = True


def disable() -> None:
    """Stop recording; the records kept so far stay until ``take``."""
    global _on, _annotate
    _on = _annotate = False


def take() -> list[Record]:
    """The records kept since the last ``take``, in the order the spans
    closed; the tracer's list is emptied."""
    global _records
    out, _records = _records, []
    return [Record._make(r) for r in out]


def write_chrome_trace(records: list[Record], path: str) -> None:
    """Records as a Chrome trace JSON at ``path``: one complete ("X")
    event per span, timestamps in microseconds on
    ``time.perf_counter_ns``'s clock, one ``tid`` per thread, the frame
    in ``args``."""
    pid = os.getpid()
    events = [{"name": r.name, "ph": "X", "pid": pid, "tid": r.thread,
               "ts": r.start_ns / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
               "args": {"frame": r.frame}} for r in records]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
