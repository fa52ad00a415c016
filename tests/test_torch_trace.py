"""The loop's tracer (``myslam_torch/utils/trace.py``) on the CPU.

  * off (the default), ``span`` is one shared object that keeps nothing
    and opens no ``record_function``;
  * on, each record holds its enclosing span on the same thread, the
    frame it was given or inherited, and its thread;
  * ``run_loop`` on ``tests/test_torch_bench.py``'s tiny configuration
    (6 frames, mapped 0, 4 and 5) has one ``frame`` span per frame,
    tracked frames x ``tracking.iters`` ``track.iter`` spans and the sum
    of ``map_iters`` ``map.iter`` spans, each span under the one the
    table of ``trace.py`` puts it under, and ``frame_log`` keeps its keys;
  * annotated, under a CPU ``torch.profiler`` (2 frames, twice): every
    span is an event with the same children, its start agrees with the
    tracer's within 100 us of the median offset (all but 1 % of them:
    descheduling on a shared CPU), and the ATen operations
    under each ``track.iter`` count the same in both runs.
"""

import statistics
import sys
import threading
from collections import Counter

import pytest
import torch

from myslam_torch.engine.scheduler import SLAMSystem
from myslam_torch.utils import trace
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
from test_torch_bench import _tiny_config

torch.set_num_threads(2)  # several test workers share the CPU

SPANS = ("frame", "prefetch_wait", "sync", "track.group", "track.pack",
         "track.iter", "track.loss", "track.grad", "track.step",
         "map.frame", "map.select", "map.iter", "map.loss", "map.backward",
         "map.step", "map.writeback", "post_map")
# Each span's enclosing span in the loop (None: the loop's top level).
PARENTS = {"frame": {None}, "prefetch_wait": {None},
           "sync": {"frame", None}, "track.group": {"frame"},
           "track.pack": {"track.group"}, "track.iter": {"track.group"},
           "track.loss": {"track.iter"}, "track.grad": {"track.iter"},
           "track.step": {"track.iter"}, "map.frame": {"frame"},
           "map.select": {"map.frame"}, "map.iter": {"map.frame"},
           "map.loss": {"map.iter"}, "map.backward": {"map.iter"},
           "map.step": {"map.iter"}, "map.writeback": {"map.frame"},
           "post_map": {"frame"}}
TRACK_KEYS = {"track_host_ms", "track_ms", "track_loss_first",
              "track_loss_best"}
MAP_KEYS = {"map_host_ms", "map_ms", "map_iters", "map_importance",
            "map_loss_first", "map_loss_last", "map_loss"}


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _loop(tmp_path, n_frames):
    cfg = load_config(_tiny_config(tmp_path), DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = n_frames
    cfg["tracking"]["pixels"] = 64
    cfg["mapping"]["pixels"] = 128
    return SLAMSystem(cfg, seed=0, device="cpu")


def test_off_keeps_nothing_and_opens_no_annotation(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = trace.span("frame", 3), trace.span("sync")
    assert a is b
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with a, b:
            torch.ones(2).add_(1)
    assert trace.take() == []
    assert not {e.name for e in prof.events()} & set(SPANS)


def test_nesting_parents_frames_and_threads():
    trace.enable()
    with trace.span("frame", 7) as outer:
        with trace.span("map.frame"):
            with trace.span("map.iter"):
                pass
        with trace.span("track.group", 4):
            pass
    seen = {}

    def worker():
        with trace.span("prefetch_wait"):
            with trace.span("sync", 9):
                seen["thread"] = threading.get_native_id()

    t = threading.Thread(target=worker)
    t.start()
    t.join(30)
    assert not t.is_alive()
    trace.disable()
    with trace.span("frame", 8):  # off again: nothing kept
        pass
    recs = {r.name: r for r in trace.take()}
    assert trace.take() == []
    assert set(recs) == {"frame", "map.frame", "map.iter", "track.group",
                         "prefetch_wait", "sync"}
    me = threading.get_native_id()
    assert recs["frame"].id == outer.id and recs["frame"].parent is None
    assert recs["map.frame"].parent == recs["frame"].id
    assert recs["map.iter"].parent == recs["map.frame"].id
    assert recs["track.group"].parent == recs["frame"].id
    assert [recs[n].frame for n in ("frame", "map.frame", "map.iter",
                                    "track.group")] == [7, 7, 7, 4]
    assert {recs[n].thread for n in ("frame", "map.iter")} == {me}
    # The other thread's spans nest among themselves alone.
    assert recs["prefetch_wait"].parent is None
    assert recs["sync"].parent == recs["prefetch_wait"].id
    assert (recs["prefetch_wait"].frame, recs["sync"].frame) == (None, 9)
    assert recs["sync"].thread == seen["thread"] != me
    for r in recs.values():
        assert r.start_ns <= r.end_ns
    assert recs["frame"].start_ns <= recs["map.frame"].start_ns \
        <= recs["map.iter"].end_ns <= recs["frame"].end_ns


@pytest.fixture(scope="module")
def loop_spans(tmp_path_factory):
    slam = _loop(tmp_path_factory.mktemp("loop"), 6)
    trace.enable()
    try:
        slam.run_loop()
    finally:
        trace.disable()
    return slam, trace.take()


def test_loop_span_counts_and_frame_log(loop_spans):
    slam, recs = loop_spans
    n = Counter(r.name for r in recs)
    assert set(n) == set(SPANS)
    iters = int(slam.cfg["tracking"]["iters"])
    log = slam.frame_log
    tracked = [r for r in log if "track_ms" in r]
    mapped = [r for r in log if "map_ms" in r]
    assert [r["frame"] for r in mapped] == [0, 4, 5]
    assert n["frame"] == len(log) == 6
    assert n["track.iter"] == len(tracked) * iters == 10
    assert n["map.iter"] == sum(r["map_iters"] for r in mapped)
    assert n["track.group"] == n["track.pack"] == 2
    assert n["map.frame"] == n["map.select"] == n["map.writeback"] == 3
    for name in ("loss", "grad", "step"):
        assert n[f"track.{name}"] == n["track.iter"]
    for name in ("loss", "backward", "step"):
        assert n[f"map.{name}"] == n["map.iter"]
    # The drains around each group and mapped frame, the final drain and
    # the metrics' read-back.
    assert n["sync"] == 2 * (n["track.group"] + n["map.frame"]) + 2
    assert n["prefetch_wait"] == 7  # 6 packets and the end
    # frame_log keeps its keys.
    for r in log:
        keys = {"frame", "frame_ms"}
        if r["frame"]:
            keys |= TRACK_KEYS
        if r in mapped:
            keys |= MAP_KEYS
        assert set(r) == keys, r["frame"]


def test_loop_spans_nest_as_the_table_says(loop_spans):
    _, recs = loop_spans
    by_id = {r.id: r for r in recs}
    me = threading.get_native_id()
    for r in recs:
        parent = by_id[r.parent] if r.parent is not None else None
        assert (parent and parent.name) in PARENTS[r.name], r
        assert r.thread == me
        if parent is not None:
            assert parent.start_ns <= r.start_ns <= r.end_ns \
                <= parent.end_ns
    groups = sorted(r.frame for r in recs if r.name == "track.group")
    assert groups == [1, 5]
    assert sorted(r.frame for r in recs if r.name == "map.frame") \
        == [0, 4, 5]
    assert {r.frame for r in recs if r.name.startswith("track.")} == {1, 5}
    assert sorted(r.frame for r in recs if r.name == "frame") \
        == list(range(6))


def _profiled_loop(tmp_path):
    slam = _loop(tmp_path, 2)
    # Every operation's call lets another thread take the interpreter
    # lock, for up to the switch interval, between the tracer's stamp and
    # the profiler's; a long interval keeps the lock with the loop until
    # it blocks, so that the two clocks alone are compared.
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1.0)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            trace.enable(annotate=True)
            try:
                slam.run_loop()
            finally:
                trace.disable()
    finally:
        sys.setswitchinterval(interval)
    return trace.take(), prof.events()


def _descendants(e):
    for c in e.cpu_children:
        yield c
        yield from _descendants(c)


def test_annotated_spans_under_the_profiler(tmp_path):
    runs = []
    for k in range(2):
        (tmp_path / f"run{k}").mkdir()
        runs.append(_profiled_loop(tmp_path / f"run{k}"))
    aten = []
    for recs, events in runs:
        spans = [e for e in events if e.name in SPANS]
        by_name = {}
        for e in spans:
            by_name.setdefault(e.name, []).append(e)
        offsets = []
        children = {}
        for r in recs:
            children.setdefault(r.parent, []).append(r.name)
        for name in {r.name for r in recs}:
            mine = sorted((r for r in recs if r.name == name),
                          key=lambda r: r.start_ns)
            theirs = sorted(by_name.get(name, []),
                            key=lambda e: e.time_range.start)
            assert len(mine) == len(theirs), name
            for r, e in zip(mine, theirs):
                offsets.append(1e3 * e.time_range.start - r.start_ns)
                assert sorted(children.get(r.id, [])) == sorted(
                    c.name for c in e.cpu_children if c.name in SPANS), name
        # Within 100 us of the median offset; on a shared CPU the kernel
        # may deschedule the loop between the two stamps of a few spans.
        mid = statistics.median(offsets)
        far = sum(1 for o in offsets if abs(o - mid) >= 100e3)  # ns
        assert far <= 0.01 * len(offsets), far
        aten.append([sum(1 for d in _descendants(e)
                         if d.name.startswith("aten::"))
                     for e in by_name["track.iter"]])
    assert aten[0] == aten[1] and len(aten[0]) == 2 and min(aten[0]) > 0


def test_importance_span_and_counts():
    """The renderer's importance branch: one ``render.importance`` span
    per pass under the caller's span, only with the tracer on and never
    without ``importance``; ``IMPORTANCE_COUNTS`` adds one pass, the rays
    and rays x ``n_stratified`` coarse points per pass, and nothing
    without ``importance``."""
    from myslam_torch.core.sampling import TorchDraws
    from myslam_torch.models.config import get_model
    from myslam_torch.models.planes import init_map_state
    from myslam_torch.render import renderer

    cfg = load_config("configs/Synthetic/room_smoke.yaml", DEFAULT_CONFIG)
    cfg["rendering"].update(n_stratified=4, n_importance=2)
    scene = renderer.scene_from_cfg(cfg)
    gen = torch.Generator().manual_seed(0)
    ms = init_map_state(gen, scene.sdf_layout, scene.color_layout,
                        get_model(cfg, gen))
    R = 16
    rays_o = torch.tensor(scene.bound, dtype=torch.float32).mean(1)
    rays_o = rays_o.expand(R, 3).contiguous()
    rays_d = torch.randn((R, 3), generator=gen)
    depth = torch.rand((R,), generator=gen) + 0.5
    depth[::4] = 0.0
    counts = renderer.IMPORTANCE_COUNTS

    def render(importance):
        before = dict(counts)
        renderer.render_rays(TorchDraws(1, "cpu"), ms, scene, rays_o,
                             rays_d, depth, importance)
        return {k: counts[k] - before[k] for k in counts}

    one = {"passes": 1, "rays": R, "points": R * 4}
    none = {"passes": 0, "rays": 0, "points": 0}
    assert render(True) == one and render(False) == none
    assert trace.take() == []
    trace.enable()
    with trace.span("map.loss", 3) as caller:
        assert render(True) == one
        assert render(False) == none
        assert render(True) == one
    trace.disable()
    assert render(True) == one
    recs = trace.take()
    imp = [r for r in recs if r.name == "render.importance"]
    assert len(imp) == 2 and len(recs) == 3
    assert all(r.parent == caller.id and r.frame == 3 for r in imp)
