"""The share of the traced sub-window, in %, in which no device
operation runs: one minus the union of the trace's device intervals over
the sub-window's length."""


def read(run):
    tr = run["trace"]
    if not run["cuda"] or tr is None or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
