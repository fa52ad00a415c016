"""The device's peak allocated memory, GiB, up to the window's end
(``torch.cuda.max_memory_allocated``)."""


def read(run):
    if not run["cuda"] or run["memory_peak_bytes"] is None:
        return None
    return run["memory_peak_bytes"] / 2 ** 30
