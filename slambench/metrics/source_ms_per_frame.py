"""The benchmark's frame source: host CPU milliseconds per frame it
rendered (its thread's CPU time in the calls, in the loop's prefetch
thread; the render itself runs on the card on a stream of its own), to
set beside the loop's milliseconds per frame."""


def read(run):
    return run["source_ms_per_frame"]
