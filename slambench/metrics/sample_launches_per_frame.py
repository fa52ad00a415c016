"""K1 and K2 launches per window frame (``cuda_sample.LAUNCHES``, read
before and after the window)."""


def read(run):
    if not run["frames"]:
        return None
    return run["launches"] / run["frames"]
