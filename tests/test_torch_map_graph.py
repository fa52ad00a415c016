"""The frame mapper's iteration body (``engine/mapper.py``) on the CPU.

A CUDA graph needs the card, so here the iteration body that the card
replays (``StaticMap.body`` over the fixed buffers: the window's pose
leaf, mask, lines and slot count, the draw slots, the gradients handed
to Adam's step as ``.grad``) runs eagerly on CPU tensors, as the frame
mapper runs it off the card (``MapGraph``): one mapped frame of 3
iterations with joint poses over a store of three keyframes, held bit
for bit against the eager loop that the sharded mappers keep
(``_iterate``) on the same frame: losses, atlases, decoders, the
written-back poses and the trajectory, with the importance branch on and
off, over the float and the packed store.  Both must draw the same
numbers in the same order and shapes, which the benchmark's recorder
(``RecordingDraws``) keeps and ``ReplayDraws`` hands back, and the
optimizer that ``make_map_optimizer`` makes, wrapped as the benchmark
wraps it, must see every step.  The gate (``replayable``) must send CPU
tensors, sharded mappers, another map backend, a replaced sample entry
point and a frame with panels to the eager path, and ``GRAPH_COUNTS``
count the eager iterations.  The card's replay is held against the eager
loop in ``test_torch_cuda.py``.
"""

import types

import numpy as np
import pytest
import torch

from myslam_torch.core.sampling import ReplayDraws, TorchDraws
from myslam_torch.engine import mapper
from myslam_torch.engine.camera import Camera
from myslam_torch.engine.keyframes import KeyframeStore, \
    make_window_selector
from myslam_torch.models.decoders import Decoders
from myslam_torch.models.planes import init_map_state, make_layout
from myslam_torch.ops import cuda_sample
from myslam_torch.render.renderer import SceneGeometry

ITERS, N_RAYS, CAPACITY, WINDOW = 3, 64, 6, 3
KEYFRAMES = 3


def setup_case(device="cpu", importance=False, packed=False,
               n_rays=N_RAYS, iters=ITERS, seed=0, eager_loop=False):
    """A small map, camera and store of KEYFRAMES keyframes with depth
    holes, the frame mapper over it, and the frame to map (joint poses,
    no admission): ``(map_frame, ms, store, est, args)``, ``args`` the
    frame's arguments after ``est`` but the draws.  ``eager_loop``: the
    frame mapper runs ``_iterate`` (it is built without a ``MapGraph``)."""
    bound = np.array([[-1, 1], [-1, 1], [-1, 1]], np.float32)
    c_dim = 8
    layout = make_layout(bound, [0.5, 0.25], c_dim)
    scene = SceneGeometry(
        sdf_layout=layout, color_layout=layout,
        bound=tuple(map(tuple, bound.tolist())), truncation=0.1,
        n_stratified=6, n_importance=2, perturb=True)
    gen = torch.Generator().manual_seed(seed)
    dec = Decoders(in_dim=2 * c_dim, generator=gen)
    ms = init_map_state(gen, layout, layout, dec, std=0.1)
    for name in ("sdf_atlas", "color_atlas"):
        setattr(ms, name, getattr(ms, name).detach().to(device)
                .requires_grad_())
    ms.decoder.to(device)
    cam = Camera(H=24, W=32, fx=20.0, fy=20.0, cx=15.5, cy=11.5)
    cfg = {"mapping": {
        "pixels": n_rays, "iters": iters, "w_color": 5.0, "w_depth": 1.0,
        "w_sdf_fs": 10.0, "w_sdf_center": 200.0, "w_sdf_tail": 50.0,
        "joint_opt_cam_lr": 0.001, "map_bf16": False,
        "lr": {"decoders_lr": 0.01, "planes_lr": 0.05,
               "c_planes_lr": 0.05}},
        "rendering": {"learnable_beta": True}}
    w_max = WINDOW + 2
    scratch = CAPACITY - 1
    store = KeyframeStore(CAPACITY, cam, device,
                          mode="packed" if packed else "device")
    rng = np.random.default_rng(seed + 1)
    n = KEYFRAMES + 1

    def frame(f):
        color = torch.tensor(rng.integers(0, 255, (cam.H, cam.W, 3)),
                             dtype=torch.uint8, device=device)
        depth = torch.tensor(rng.integers(3000, 12000, (cam.H, cam.W)),
                             dtype=torch.uint16, device=device)
        depth[:, :4] = 0  # holes
        c2w = torch.eye(4, device=device)
        c2w[:3, 3] = torch.tensor([0.02 * f, -0.01, -0.6], device=device)
        return color, depth, c2w

    est = torch.eye(4, device=device).repeat(n, 1, 1)
    for f in range(KEYFRAMES):
        color, depth, c2w = frame(f)
        store.write_packet(f, color, depth, 1e-4)
        store.est_c2w[f] = c2w
        store.gt_c2w[f] = c2w
        store.has_depthless[f] = True
        est[f] = c2w
    store.count = KEYFRAMES
    color, depth, c2w = frame(KEYFRAMES)
    est[KEYFRAMES] = c2w
    est[KEYFRAMES, 0, 3] += 0.01
    selector = make_window_selector(cam, CAPACITY, WINDOW, w_max, scratch,
                                    method="global")
    with pytest.MonkeyPatch.context() as mp:
        if eager_loop:
            mp.setattr(mapper, "MapGraph", lambda *a: None)
        map_frame = mapper.make_frame_mapper(
            cfg, scene, cam, selector, w_max, scratch,
            importance=importance, packed=packed)
    args = (color, depth, 1e-4, c2w, KEYFRAMES)
    return map_frame, ms, store, est, args


def run_frame(case, draws, iters=ITERS):
    """``case``'s frame mapped; returns the losses and copies of the map,
    the store's poses and the trajectory."""
    map_frame, ms, store, est, args = case
    losses = map_frame(ms, store, est, *args, draws, iters=iters,
                       lr_factor=1.0, joint_opt=True, admit=False)
    leaves = [ms.sdf_atlas, ms.color_atlas, *ms.decoder.parameters(),
              store.est_c2w, est]
    return [losses.clone()] + [t.detach().clone() for t in leaves]


class Recording:
    """Draws from a seeded source, each kept, in order."""

    def __init__(self, base):
        self.base = base
        self.kept = []

    def uniform(self, shape):
        t = self.base.uniform(shape)
        self.kept.append(("uniform", t.clone()))
        return t

    def randint(self, shape, low, high):
        t = self.base.randint(shape, low, high)
        self.kept.append(("randint", t.clone()))
        return t


@pytest.mark.parametrize("importance,packed",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_static_body_matches_the_eager_loop(importance, packed):
    eager_draws = Recording(TorchDraws(5, "cpu"))
    static_draws = Recording(TorchDraws(5, "cpu"))
    eager = run_frame(setup_case(importance=importance, packed=packed,
                                 eager_loop=True), eager_draws)
    static = run_frame(setup_case(importance=importance, packed=packed),
                       static_draws)
    for got, want in zip(static, eager):
        assert got.shape == want.shape
        assert torch.equal(got, want)
    # The map and the window's poses moved: the comparison is not vacuous.
    start = setup_case(importance=importance, packed=packed)
    assert not torch.equal(static[1], start[1].sdf_atlas.detach())
    assert not torch.equal(static[-2], start[2].est_c2w)
    # Same draws, in the same order, kinds and shapes: the selector's,
    # then per iteration two randints and the renderer's uniforms.
    per_iter = 3 + (2 if importance else 0)
    assert len(static_draws.kept) == len(eager_draws.kept)
    assert len(eager_draws.kept) == 1 + ITERS * per_iter
    for (k1, a), (k2, b) in zip(static_draws.kept, eager_draws.kept):
        assert k1 == k2 and a.shape == b.shape and torch.equal(a, b)


def test_static_body_replays_the_recorded_draws():
    """The benchmark's check replays the program's draws by shape: the
    recorder's draws of an eager frame, handed back by ``ReplayDraws``,
    map the frame through the body exactly as the eager loop did."""
    from slambench.record import RecordingDraws

    rec = RecordingDraws(TorchDraws(8, "cpu"), lambda t: t.clone())
    eager = run_frame(setup_case(importance=True, eager_loop=True), rec)
    static = run_frame(setup_case(importance=True), ReplayDraws(rec.kept))
    for got, want in zip(static, eager):
        assert torch.equal(got, want)


def test_wrapped_optimizer_sees_every_step(monkeypatch):
    """``make_map_optimizer`` wrapped as ``slambench/record.py`` wraps it:
    the body's frame makes it once, over the pose leaf, and calls its
    step after every iteration, so the wrapper keeps iters + 1 states."""
    make = mapper.make_map_optimizer
    seen = []

    def wrapped(cfg, ms, poses, lr_factor):
        opt = make(cfg, ms, poses, lr_factor)
        states = [ms.sdf_atlas.detach().clone()]
        pose_states = [poses.detach().clone()]
        step = opt.step

        def step_and_keep(*a, **k):
            out = step(*a, **k)
            states.append(ms.sdf_atlas.detach().clone())
            pose_states.append(poses.detach().clone())
            return out

        opt.step = step_and_keep
        seen.append((states, pose_states))
        return opt

    monkeypatch.setattr(mapper, "make_map_optimizer", wrapped)
    run_frame(setup_case(), TorchDraws(3, "cpu"))
    assert len(seen) == 1
    states, pose_states = seen[0]
    assert len(states) == len(pose_states) == ITERS + 1
    for a, b in zip(states, states[1:]):
        assert not torch.equal(a, b)
    assert not torch.equal(pose_states[0], pose_states[-1])


def test_slot_draws_refuse_a_draw_out_of_schedule():
    schedule = [("randint", (4,), 0, 3), ("uniform", (4, 2), None, None)]
    slots = [torch.zeros(4, dtype=torch.int64), torch.zeros(4, 2)]
    src = mapper._SlotDraws(schedule, slots)
    with pytest.raises(ValueError):
        src.uniform((4, 2))  # the schedule starts with a randint
    src = mapper._SlotDraws(schedule, slots)
    with pytest.raises(ValueError):
        src.randint((4,), 0, 5)  # another range
    src = mapper._SlotDraws(schedule, slots)
    assert src.randint((4,), 0, 3) is slots[0]
    with pytest.raises(ValueError):
        src.done()  # one slot left
    assert src.uniform((4, 2)) is slots[1]
    src.done()
    with pytest.raises(ValueError):
        src.uniform((4, 2))  # past the schedule's end


def test_gate_takes_the_eager_path_where_a_graph_cannot_follow(monkeypatch):
    card = types.SimpleNamespace(device=torch.device("cuda"))
    assert mapper.replayable(card, False, True, None)
    assert not mapper.replayable(torch.zeros(4), False, True, None)  # CPU
    assert not mapper.replayable(card, True, True, None)  # sharded
    assert not mapper.replayable(card, False, False, None)  # map shards
    assert not mapper.replayable(card, False, True, lambda *a: None)
    for name in ("plane_sample_fwd", "plane_sample_bwd"):
        own = getattr(cuda_sample, name)
        monkeypatch.setattr(cuda_sample, name, lambda *a, _f=own, **k:
                            _f(*a, **k))
        assert not mapper.replayable(card, False, True, None)
        monkeypatch.undo()
    assert mapper.replayable(card, False, True, None)

    # On CPU tensors the frame mapper runs the body eagerly, and counts it.
    before = dict(mapper.GRAPH_COUNTS)
    map_frame, ms, store, est, args = setup_case()
    map_frame(ms, store, est, *args, TorchDraws(1, "cpu"), iters=ITERS,
              lr_factor=1.0, joint_opt=True, admit=False)
    after = mapper.GRAPH_COUNTS
    assert after["eager_iters"] - before["eager_iters"] == ITERS
    assert after["replays"] == before["replays"]
    assert after["captures"] == before["captures"]


def test_panels_see_what_the_eager_loop_shows():
    """A frame with panels runs the body eagerly and calls ``vis_hook``
    before the same iterations, with the same map and current pose, as
    the eager loop does."""
    def mapped(case):
        map_frame, ms, store, est, args = case
        shown = []

        def hook(it, ms_now, c2w):
            shown.append((it, ms_now.sdf_atlas.detach().clone(),
                          c2w.clone()))

        map_frame(ms, store, est, *args, TorchDraws(4, "cpu"), iters=4,
                  lr_factor=1.0, joint_opt=True, admit=False,
                  vis_hook=hook, vis_every=2)
        return shown

    body = mapped(setup_case(iters=4))
    loop = mapped(setup_case(iters=4, eager_loop=True))
    assert [s[0] for s in body] == [s[0] for s in loop] == [2]
    for (_, a, p), (_, b, q) in zip(body, loop):
        assert torch.equal(a, b) and torch.equal(p, q)
