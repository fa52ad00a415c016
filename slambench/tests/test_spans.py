"""CPU tests of ``slambench/spans.py``: its reductions on made-up records
and events, and a rehearsal of each cell.

    python -m pytest slambench/tests/test_spans.py -q
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from myslam_torch.utils.trace import Record
from slambench import spans

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    WORKLOADS = [w["name"] for w in json.load(_f)["workloads"]]
MS = 1_000_000  # ns


def test_window_metrics_sums_means_and_coverage():
    # Two frames on thread 1 from 0 to 10 ms and 11 to 20 ms; a frame on
    # another thread is not the loop's.
    recs = [
        Record("frame", 0, 10 * MS, None, 5, 1, 0),
        Record("track.iter", 1 * MS, 3 * MS, 0, 5, 1, 1),
        Record("track.loss", 1 * MS, 2 * MS, 1, 5, 1, 2),
        Record("sync", 3 * MS, 4 * MS, 0, 5, 1, 3),
        Record("prefetch_wait", 10 * MS, 11 * MS, None, None, 1, 4),
        Record("frame", 11 * MS, 20 * MS, None, 6, 1, 5),
        Record("map.iter", 12 * MS, 16 * MS, 5, 6, 1, 6),
        Record("map.iter", 16 * MS, 18 * MS, 5, 6, 1, 7),
        Record("sync", 18 * MS, 19 * MS, 5, 6, 1, 8),
        Record("frame", 0, 20 * MS, None, 5, 2, 9),
    ]
    out = spans.window_metrics(recs, 0, 20 * MS, 20 * MS, 2)
    assert out["prefetch_wait_ms_per_frame"] == 0.5
    assert out["sync_ms_per_frame"] == 1.0
    assert out["track_iter_host_ms"] == 2.0 and out["map_iter_host_ms"] == 3.0
    assert out["frame_coverage"] == pytest.approx(0.95)
    assert out["self_ms_per_iter"]["track.iter"] == {
        "track.iter": 1.0, "track.loss": 1.0, "track.grad": 0.0,
        "track.step": 0.0}
    assert out["span_counts"]["frame"] == 2


def _event(name, thread, parent=None, seq=-1, fwd=0, kernels=0):
    e = SimpleNamespace(name=name, thread=thread, cpu_parent=parent,
                        sequence_nr=seq, fwd_thread=fwd,
                        kernels=[SimpleNamespace(name="k")] * kernels)
    return e


def test_backward_launches_follow_the_forward_iteration():
    """A backward node on the engine's thread (2) belongs to the
    iteration of the forward operation with its sequence number; one
    without a forward on the loop's thread (1) belongs to none."""
    it0 = _event("track.iter", 1)
    it1 = _event("track.iter", 1)
    mul = _event("aten::mul", 1, it0, seq=7, kernels=1)
    sin = _event("aten::sin", 1, it1, seq=8, kernels=1)
    node = _event("autograd::engine::evaluate_function: MulBackward0", 2,
                  seq=7, fwd=1)
    inner = _event("aten::mul", 2, node, kernels=2)
    other = _event("aten::add", 2, _event("evaluate_function", 2, seq=9,
                                          fwd=1), kernels=1)
    render = _event("aten::add", 3, kernels=1)
    host = [it0, it1, mul, sin, node, inner, other, render]
    of = spans._iteration_of(host, 1)
    assert of(mul) is it0 and of(sin) is it1 and of(inner) is it0
    assert of(other) is None and of(render) is None


@pytest.mark.parametrize("workload", WORKLOADS)
def test_rehearsal_prints_the_span_numbers(workload):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "spans.py"), "--workload",
         workload, "--seed", "2147483653", "--seconds", "1", "--pairs", "1",
         "--pair-groups", "1", "--rehearse"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    window, phase, *pair = line["phases"]
    assert line["device"] == "cpu" and len(pair) == 2
    for name in ("prefetch_wait_ms_per_frame", "sync_ms_per_frame"):
        assert window[name] >= 0
    for name in ("track_iter_host_ms", "map_iter_host_ms"):
        assert window[name] > 0
    assert 0.9 < window["frame_coverage"] <= 1
    # No device: the launches and the idle time are not measured.
    for name in ("track_launches_per_iter", "map_launches_per_iter",
                 "idle_s"):
        assert phase[name] is None
    assert phase["offset_spans"] > 0
    assert 0 < line["span_off_ns"] < line["span_on_ns"]
    assert {p["mode"] for p in pair} == {"on", "off"}
