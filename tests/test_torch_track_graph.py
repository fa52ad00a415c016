"""The tracker's iteration body (``engine/tracker.py``) on the CPU.

A CUDA graph needs the card, so here the iteration body that the card
replays (``StaticFrame.body``: the fixed buffers, the jitter slots,
``torch.optim.Adam``'s step over the pose leaves, the bookkeeping) runs
eagerly on CPU tensors, two frames of 3 iterations against a small map,
and is held against a plain loop over the same loss (a fresh Adam per
frame, each iteration's pixels indexed on the host) at 1e-6 of their
largest value.  Both must draw the same numbers in the same order and
shapes, and a frame's results must not be overwritten by the next
frame's.  The gate (``replayable``) must send CPU tensors, sharded
trackers and a replaced sample entry point to the eager path.  The JAX
package's tracker is held against the same body in
``test_torch_slice.py`` and ``test_torch_parallel.py``.
"""

import types

import numpy as np
import pytest
import torch

from myslam_torch.core.quaternion import matrix_to_cam_pose
from myslam_torch.core.sampling import TorchDraws
from myslam_torch.engine import tracker
from myslam_torch.engine.camera import Camera
from myslam_torch.models.decoders import Decoders
from myslam_torch.models.planes import init_map_state, make_layout
from myslam_torch.ops import cuda_sample
from myslam_torch.render.renderer import SceneGeometry

ITERS, N_PX = 3, 64


def _setup():
    bound = np.array([[-1, 1], [-1, 1], [-1, 1]], np.float32)
    c_dim = 8
    layout = make_layout(bound, [0.5, 0.25], c_dim)
    scene = SceneGeometry(
        sdf_layout=layout, color_layout=layout,
        bound=tuple(map(tuple, bound.tolist())), truncation=0.1,
        n_stratified=6, n_importance=2, perturb=True)
    gen = torch.Generator().manual_seed(0)
    dec = Decoders(in_dim=2 * c_dim, generator=gen)
    ms = init_map_state(gen, layout, layout, dec, std=0.1)
    cam = Camera(H=24, W=32, fx=20.0, fy=20.0, cx=15.5, cy=11.5)
    cfg = {"tracking": {
        "pixels": N_PX, "iters": ITERS, "w_color": 5.0, "w_depth": 1.0,
        "w_sdf_fs": 10.0, "w_sdf_center": 200.0, "w_sdf_tail": 50.0,
        "lr_T": 0.01, "lr_R": 0.01, "map_bf16": False}}
    return cfg, scene, cam, ms


def _frames(cam):
    rng = np.random.default_rng(3)
    frames = []
    for f in range(2):
        px_i = torch.tensor(rng.integers(2, cam.W - 2, (ITERS, N_PX)))
        px_j = torch.tensor(rng.integers(2, cam.H - 2, (ITERS, N_PX)))
        px_color = torch.tensor(rng.integers(0, 255, (ITERS, N_PX, 3)),
                                dtype=torch.uint8)
        px_depth = torch.tensor(rng.uniform(0.3, 1.2, (ITERS, N_PX)),
                                dtype=torch.float32)
        c2w = torch.eye(4)
        c2w[:3, 3] = torch.tensor([0.02 * f, -0.01, -0.6])
        frames.append((matrix_to_cam_pose(c2w), px_i, px_j, px_color,
                       px_depth))
    return frames


class Recording:
    """Draws from a seeded source, each kept with its shape."""

    def __init__(self, seed):
        self.base = TorchDraws(seed, "cpu")
        self.kept = []

    def uniform(self, shape):
        t = self.base.uniform(shape)
        self.kept.append(t.clone())
        return t

    def randint(self, shape, low, high):
        t = self.base.randint(shape, low, high)
        self.kept.append(t.clone())
        return t


def _close(got, want):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale


def _plain_core(core, ms, quads, pose_init, px_i, px_j, px_color, px_depth,
                draws):
    """The per-frame optimization written out plainly: a fresh Adam,
    the loss at each pre-update pose, the best pose by loss."""
    R = pose_init[:4].detach().clone().requires_grad_()
    T = pose_init[4:].detach().clone().requires_grad_()
    opt = torch.optim.Adam([{"params": [R], "lr": core.lr_R},
                            {"params": [T], "lr": core.lr_T}],
                           betas=tracker.ADAM_BETAS)
    best_loss, best_pose = float("inf"), pose_init.detach()
    losses, poses = [], []
    for it in range(core.iters):
        loss = core.loss_fn(R, T, ms, quads, px_i[it], px_j[it],
                            px_color[it], px_depth[it], draws)
        R.grad, T.grad = torch.autograd.grad(loss, [R, T])
        pose, loss = torch.cat([R, T]).detach(), loss.detach()
        if float(loss) < best_loss:
            best_loss, best_pose = float(loss), pose
        losses.append(loss)
        poses.append(pose)
        opt.step()
    return best_pose, torch.stack(losses), torch.stack(poses)


def test_static_body_matches_the_eager_core():
    cfg, scene, cam, ms = _setup()
    core = tracker.make_track_core(cfg, scene, cam)
    quads = tracker.pack_tracking_quads(ms, scene, False)
    frames = _frames(cam)
    plain_draws, static_draws = Recording(9), Recording(9)
    plain, static = [], []
    for pose_init, *px in frames:
        plain.append(_plain_core(core, ms, quads, pose_init, *px,
                                 plain_draws))
        static.append(core(ms, quads, pose_init, *px, static_draws))
    kept = [tuple(t.clone() for t in out) for out in static]
    for want, got in zip(plain, static):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g, w)
        # The pose moved: the comparison is not vacuous.
        assert float((got[2][-1] - got[2][0]).abs().max()) > 1e-4
    # Same draws, in the same order and shapes.
    assert len(static_draws.kept) == len(plain_draws.kept) == 2 * ITERS
    for a, b in zip(static_draws.kept, plain_draws.kept):
        assert a.shape == b.shape == (N_PX, scene.n_samples)
        assert torch.equal(a, b)
    # Frame 0's results survived frame 1 and share no storage with it.
    for out, copy in zip(static[0], kept[0]):
        assert torch.equal(out, copy)
    ptrs = {t.data_ptr() for t in static[1]}
    assert not ptrs & {t.data_ptr() for t in static[0]}
    st = core.static
    assert not ptrs & {t.data_ptr() for t in (st.best_pose, st.losses,
                                              st.poses)}
    # New quads are copied in; the same quads are not copied again.
    assert all(r() is q for r, q in zip(st.quad_src, quads))
    # One optimizer for both frames, its state zeroed in place.
    assert all(int(s["step"]) == ITERS for s in st.opt.state.values())


def test_static_body_refuses_a_draw_it_has_no_slot_for():
    jitter = torch.zeros((2, 4, 3))
    slot = tracker._SlotDraws(jitter, torch.ones(1, dtype=torch.int64))
    with pytest.raises(ValueError):
        slot.uniform((4, 2))
    with pytest.raises(ValueError):
        slot.randint((4,), 0, 3)
    assert slot.uniform((4, 3)) is not None
    with pytest.raises(ValueError):
        slot.uniform((4, 3))  # one draw per iteration


def test_gate_takes_the_eager_path_where_a_graph_cannot_follow(monkeypatch):
    card = types.SimpleNamespace(device=torch.device("cuda"))
    assert tracker.replayable(card, sharded=False)
    assert not tracker.replayable(card, sharded=True)
    assert not tracker.replayable(torch.zeros(7), sharded=False)
    own_fwd = cuda_sample.plane_sample_fwd
    monkeypatch.setattr(cuda_sample, "plane_sample_fwd",
                        lambda *a, **k: own_fwd(*a, **k))
    assert not tracker.replayable(card, sharded=False)
    monkeypatch.undo()
    own_bwd = cuda_sample.plane_sample_bwd
    monkeypatch.setattr(cuda_sample, "plane_sample_bwd",
                        lambda *a, **k: own_bwd(*a, **k))
    assert not tracker.replayable(card, sharded=False)
    monkeypatch.undo()
    assert tracker.replayable(card, sharded=False)

    # On CPU tensors the core runs eagerly.
    cfg, scene, cam, ms = _setup()
    core = tracker.make_track_core(cfg, scene, cam)
    quads = tracker.pack_tracking_quads(ms, scene, False)
    pose_init, *px = _frames(cam)[0]
    before = dict(tracker.GRAPH_COUNTS)
    core(ms, quads, pose_init, *px, TorchDraws(1, "cpu"))
    after = tracker.GRAPH_COUNTS
    assert after["eager_iters"] - before["eager_iters"] == ITERS
    assert after["replays"] == before["replays"]
    assert after["captures"] == before["captures"]
    assert core.static.graph is None


CUMPROD_SHAPES = [(300, 40), (7, 1), (2, 3, 8)]


def check_cumprod_positive(shape, device):
    """``CumprodPositive`` against ``torch.cumprod`` on ``device``: the
    same values and gradients, bit for bit, alpha = 1 included."""
    from myslam_torch.ops.composite import CumprodPositive

    gen = torch.Generator().manual_seed(4)
    alpha = torch.rand(shape, generator=gen)
    alpha.view(-1)[::5] = 1.0
    x = (1.0 - alpha + 1e-10).to(device).requires_grad_()
    grad = torch.randn(shape, generator=gen).to(device)
    want = torch.cumprod(x, dim=-1)
    got = CumprodPositive.apply(x)
    assert torch.equal(got, want)
    (g_want,) = torch.autograd.grad(want, x, grad)
    (g_got,) = torch.autograd.grad(got, x, grad)
    assert torch.equal(g_got, g_want)


@pytest.mark.parametrize("shape", CUMPROD_SHAPES)
def test_cumprod_positive_matches_torch_bit_for_bit(shape):
    """Compositing's cumulative product (``ops/composite.py``), whose
    backward reads nothing back to the host, against ``torch.cumprod``
    (``check_cumprod_positive``; the card's case is in
    ``test_torch_cuda.py``)."""
    check_cumprod_positive(shape, "cpu")
