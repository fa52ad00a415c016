"""Mapping milliseconds per window frame: the loop's own ``map_ms``
(``SLAMSystem.frame_log``, a drain before and after each mapped frame)
summed over the window's mapped frames, over the window's frame
count."""


def read(run):
    if not run["frames"]:
        return None
    return sum(run["map_ms"]) / run["frames"]
