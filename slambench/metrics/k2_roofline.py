"""K2's share of its roofline, in %: the least time of the traced
sub-window's K2 calls (``counts.bwd_work`` from each call's points, with
or without the quad gradient as the call asked) over K2's device time in
the trace."""


def read(run):
    tr, b = run["trace"], run["bounds"]
    if not run["cuda"] or tr is None or b is None or not b["bwd_calls"]:
        return None
    ms = tr["kernel_ms"]["k2"]
    return 100.0 * b["bwd_ms"] / ms if ms > 0 else None
