"""Tracking milliseconds per window frame: the loop's own ``track_ms``
(host wall from a device drain to a drain around each tracked group,
shared over its frames; ``SLAMSystem.frame_log``) summed over the
window's frames, over their count."""


def read(run):
    if not run["frames"]:
        return None
    return sum(run["track_ms"]) / run["frames"]
