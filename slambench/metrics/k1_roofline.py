"""K1's share of its roofline, in %: the least time of the traced
sub-window's K1 calls (``counts.fwd_work`` from each call's points)
over K1's device time in the trace."""


def read(run):
    tr, b = run["trace"], run["bounds"]
    if not run["cuda"] or tr is None or b is None or not b["fwd_calls"]:
        return None
    ms = tr["kernel_ms"]["k1"]
    return 100.0 * b["fwd_ms"] / ms if ms > 0 else None
