"""Seconds of frame 0's mapping (``iters_first`` iterations): the loop's
own ``map_ms`` of frame 0, the largest part of set-up."""


def read(run):
    return run["frame0_s"]
