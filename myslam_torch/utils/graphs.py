"""One iteration body captured as a CUDA graph and replayed, with the
host counters that its kernels' wrappers keep.

A captured kernel does not run at the capture, and a replay runs the
captured kernels without calling their Python wrappers.  So a
``CountedGraph`` keeps what the capture added to each counter (dicts of
ints such as ``ops/cuda_sample.LAUNCHES``), takes it back after the
capture and adds it again at each replay: the counters still count
every run on the device.  The tracker (``engine/tracker.StaticFrame``)
and the mapper (``engine/mapper.StaticMap``) replay their iterations
through it.
"""

from __future__ import annotations

import torch


class CountedGraph:
    """``body()`` captured on ``dev`` after ``warm()`` ran eagerly on a
    side stream (it sets up what a capture cannot: the kernel library,
    cached constants, library handles, an optimizer's state).  Other
    threads (the frame prefetcher's uploads) may use the device while
    this one captures.  ``out`` is what the capture's ``body()``
    returned: the graph's outputs, which each replay rewrites in
    place."""

    def __init__(self, dev, warm, body, counters: tuple):
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm()
        cur.wait_stream(side)
        before = [dict(c) for c in counters]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = body()
        self.counters = counters
        self.added = [{k: n - b.get(k, 0) for k, n in c.items()
                       if n != b.get(k, 0)}
                      for c, b in zip(counters, before)]
        self._count(-1)

    def _count(self, sign: int) -> None:
        for c, added in zip(self.counters, self.added):
            for k, n in added.items():
                c[k] += sign * n

    def replay(self) -> None:
        self.graph.replay()
        self._count(1)
