"""Share of mapping iterations replayed from a captured CUDA graph: the
program's ``engine.mapper.GRAPH_COUNTS`` (host integers, kept for the
whole process) read after the run, ``replays`` over ``replays +
eager_iters``, in percent.  The eager ones are each capture's warm-up
and the traced host-and-device phase's, whose kernel recorder replaces
the sample's entry points.  None where the program keeps no such counter
or mapped nothing."""


def read(run):
    from myslam_torch.engine import mapper

    counts = getattr(mapper, "GRAPH_COUNTS", None)
    if not counts:
        return None
    n = counts.get("replays", 0) + counts.get("eager_iters", 0)
    if not n:
        return None
    return 100.0 * counts.get("replays", 0) / n
