"""The whole step's share of the card's float32 peak, in %: the
operations of the window's tracking and mapping iterations, counted from
the configuration's shapes by ``slambench/counts.py``, over the window's
seconds, over 67 TFLOP/s."""

from slambench import counts


def read(run):
    if not run["cuda"] or not run["window_s"]:
        return None
    return 100.0 * run["ops"] / run["window_s"] / counts.F32_FLOPS
