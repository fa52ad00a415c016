"""The port's packed and host-staged keyframe stores against the JAX
package's, on the CPU.

  * (a) the packed frame mapper (``make_frame_mapper(packed=True)``) on
    tests/test_torch_mapper.py's case: frame 24 of the synthetic room
    against six stored keyframes at 120x160, three iterations, joint
    poses, and here admission on;
  * (b) the host-staged store's window mapper on the same case, with the
    window's imagery in a line cache whose lines are a permutation of the
    slots;
  * (c) the line cache's bookkeeping and contents, step by step, through
    the sequence of tests/test_host_keyframes.py::test_host_cache_lru_unit
    and 40 random steps;
  * (d) the host store's hull points (``backproject_keyframes``,
    ``denoise_observed_points``) and the host-side ``select_window``.

Tolerances are those of tests/test_torch_mapper.py (ten times the gaps
measured there): losses rtol 1e-5, map and decoder atol 1e-5, poses
atol 3e-6.  Imagery moves as bytes and is compared exactly; the hull
points are the same numpy arithmetic, held at atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.engine import keyframes as jkf
from myslam_tpu.engine import mapper as jmapper
from myslam_tpu.engine.camera import Camera as JCamera
from myslam_tpu.utils import mesher as jmesher
from myslam_torch.core.sampling import ReplayDraws
from myslam_torch.engine import keyframes as tkf
from myslam_torch.engine import mapper as tmapper
from myslam_torch.engine.camera import Camera
from myslam_torch.utils import mesher
from test_torch_slice import N, Pair, assert_map_close, \
    map_iteration_draws, selector_draws, small_cfg

torch.set_num_threads(2)  # several test workers share the CPU

CAPACITY = 8
KEYFRAMES = (0, 4, 8, 12, 16, 20)
IDX = 24
SCRATCH = CAPACITY - 1
# The host-staged case's line of each slot (and the scratch line last).
LINES = 9
LINE_OF_SLOT = np.array([5, 2, 7, 0, 3, 1, 4, 6])


def quantize(color, depth):
    """A frame's wire format, as build_packet encodes it."""
    color_u8 = np.clip(np.rint(color * 255.0), 0, 255).astype(np.uint8)
    q = 60000.0 / max(float(depth.max()), 1e-3)
    depth_u16 = np.where(depth > 0, np.clip(np.rint(depth * q), 1, 65535),
                         0).astype(np.uint16)
    return color_u8, depth_u16, np.float32(1.0 / q)


class Case:
    """tests/test_torch_mapper.py's window: six keyframes of the room in
    the wire format, noisy keyframe poses, frame 24 1 cm off."""

    def __init__(self):
        cfg = small_cfg(perturb=False)
        cfg["data"]["n_frames"] = IDX + 1
        cfg["cam"].update(H=120, W=160, fx=100.0, fy=100.0, cx=79.5,
                          cy=59.5)
        cfg["mapping"].update(iters=3, mapping_window_size=3)
        self.cfg, self.pair = cfg, Pair(cfg)
        m = cfg["mapping"]
        self.window = int(m["mapping_window_size"])
        self.w_max = self.window + 2
        self.iters = int(m["iters"])
        rng = np.random.default_rng(0)
        self.colors = np.zeros((CAPACITY, 120, 160, 3), np.uint8)
        self.depths = np.zeros((CAPACITY, 120, 160), np.uint16)
        self.inv_q = np.ones((CAPACITY,), np.float32)
        self.kf_est = np.tile(np.eye(4, dtype=np.float32), (CAPACITY, 1, 1))
        self.kf_gt = self.kf_est.copy()
        for slot, f in enumerate(KEYFRAMES):
            c, d, gt = self.pair.dataset.get_frame(f)
            self.colors[slot], self.depths[slot], self.inv_q[slot] = \
                quantize(c, d)
            self.kf_gt[slot] = self.kf_est[slot] = gt
            self.kf_est[slot, :3, 3] += rng.normal(scale=0.005, size=3)
        self.est = np.stack([self.pair.dataset.poses[f]
                             for f in range(IDX + 1)])
        self.est[IDX, :3, 3] += 0.01
        self.pkt = self.pair.packet(IDX, need_full=True)
        self.key = jax.random.PRNGKey(9)
        self.jsel = jkf.make_window_selector(
            self.pair.jcam, CAPACITY, self.window, self.w_max, SCRATCH)
        self.sel_key = jax.random.fold_in(self.key, 0x7FFFFFFF)

    def iteration_draws(self):
        out = []
        for it in range(self.iters):
            out += map_iteration_draws(
                self.key, it, int(self.cfg["mapping"]["pixels"]),
                self.pair.jcam, self.pair.jscene, False)
        return out

    def jax_selection(self):
        pkt = self.pkt
        return self.jsel(
            jnp.asarray(self.kf_est), len(KEYFRAMES),
            jnp.asarray(self.est[IDX]),
            jnp.asarray(pkt.depth_u16.astype(np.float32)
                        * np.float32(pkt.depth_inv_q)),
            self.sel_key, 1.0)


@pytest.fixture(autouse=True)
def _scatter_route(monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)


def check_window(case, pair, losses, jlosses, jms, kf_est, jkf_est, est,
                 jest, jslot_kf, jn_slots):
    np.testing.assert_allclose(N(losses), np.asarray(jlosses), rtol=1e-5)
    assert_map_close(pair.ms, jms, atol=1e-5, sdf_atol=1e-5)
    np.testing.assert_allclose(N(kf_est), np.asarray(jkf_est), atol=3e-6)
    np.testing.assert_allclose(N(est), np.asarray(jest), atol=3e-6)
    # A real window whose poses moved, but not the oldest slot's.
    assert int(jn_slots) >= 4
    moved = np.abs(np.asarray(jkf_est) - case.kf_est).max(axis=(1, 2))
    slots = np.asarray(jslot_kf)[:int(jn_slots) - 1]
    assert moved[slots[0]] == 0.0 and (moved[slots[1:]] > 0).all()
    assert np.abs(N(est)[IDX] - case.est[IDX]).max() > 0


def test_packed_frame_mapper_matches_jax():
    """(a) The packed store: the packet's bytes into the scratch slot,
    selection on its dequantized depth, the u8/u16 gather, and admission
    of the raw bytes and inv_q into slot 6."""
    case = Case()
    pair, pkt = case.pair, case.pkt
    jmap = jmapper.make_frame_mapper(
        case.cfg, pair.jscene, pair.jcam, case.jsel, case.w_max, SCRATCH,
        importance=False, packed=True)
    opt_buf = jmap.jit_init({"map": pair.jms, "poses": jnp.zeros(
        (case.w_max, 7), jnp.float32)})
    (jms, _, jest, jkf_est, jkf_gt, jcolors, (jdepths, jinv_q),
     jlosses) = jmap(
        pair.jms, opt_buf, jnp.asarray(case.est), jnp.asarray(case.kf_est),
        jnp.asarray(case.kf_gt), jnp.asarray(case.colors),
        (jnp.asarray(case.depths), jnp.asarray(case.inv_q)),
        jnp.asarray(pkt.color_u8), jnp.asarray(pkt.depth_u16),
        pkt.depth_inv_q, jnp.asarray(pkt.gt_c2w), IDX, len(KEYFRAMES),
        case.key, iters=case.iters, lr_factor=1.0, joint_opt=True,
        admit=True)
    jslot_kf, jn_slots, _ = case.jax_selection()

    store = tkf.KeyframeStore(CAPACITY, pair.cam, "cpu", mode="packed")
    store.colors[:] = torch.from_numpy(case.colors)
    store.depths_u16[:] = torch.from_numpy(case.depths)
    store.depth_inv_q[:] = torch.from_numpy(case.inv_q)
    store.est_c2w[:] = torch.tensor(case.kf_est)
    store.gt_c2w[:] = torch.tensor(case.kf_gt)
    store.count = len(KEYFRAMES)
    sel = tkf.make_window_selector(pair.cam, CAPACITY, case.window,
                                   case.w_max, SCRATCH)
    map_frame = tmapper.make_frame_mapper(
        case.cfg, pair.scene, pair.cam, sel, case.w_max, SCRATCH,
        importance=False, packed=True)
    replay = ReplayDraws(selector_draws(case.sel_key, pair.jcam, CAPACITY)
                         + case.iteration_draws())
    est = torch.tensor(case.est)
    losses = map_frame(
        pair.ms, store, est, torch.from_numpy(pkt.color_u8),
        torch.from_numpy(pkt.depth_u16), pkt.depth_inv_q,
        torch.tensor(pkt.gt_c2w), IDX, replay, iters=case.iters,
        lr_factor=1.0, joint_opt=True, admit=True)
    assert len(replay) == 0

    check_window(case, pair, losses, jlosses, jms, store.est_c2w, jkf_est,
                 est, jest, jslot_kf, jn_slots)
    np.testing.assert_array_equal(N(store.gt_c2w), np.asarray(jkf_gt))
    # The admitted slot, and the whole store, byte for byte.
    n = len(KEYFRAMES)
    assert store.colors.dtype == torch.uint8
    assert store.depths_u16.dtype == torch.uint16
    np.testing.assert_array_equal(N(store.colors), np.asarray(jcolors))
    np.testing.assert_array_equal(N(store.depths_u16), np.asarray(jdepths))
    np.testing.assert_array_equal(N(store.depth_inv_q), np.asarray(jinv_q))
    np.testing.assert_array_equal(N(store.colors[n]), pkt.color_u8)
    np.testing.assert_array_equal(N(store.depths_u16[n]), pkt.depth_u16)
    assert float(store.depth_inv_q[n]) == np.float32(pkt.depth_inv_q)


def test_window_frame_mapper_matches_jax():
    """(b) The host-staged store's mapper: the window read from cache
    lines that are not its slots, the poses written back to the global
    slots, pose-only admission at slot 6."""
    case = Case()
    pair, pkt = case.pair, case.pkt
    jslot_kf, jn_slots, jpose_mask = case.jax_selection()
    n_win = int(jn_slots)
    scratch_line = LINES - 1
    win_lines = np.full((case.w_max,), scratch_line, np.int32)
    win_lines[:n_win - 1] = LINE_OF_SLOT[np.asarray(jslot_kf)[:n_win - 1]]
    cache_c = np.zeros((LINES, 120, 160, 3), np.uint8)
    cache_d = np.zeros((LINES, 120, 160), np.uint16)
    cache_q = np.ones((LINES,), np.float32)
    for slot in range(len(KEYFRAMES)):
        ln = LINE_OF_SLOT[slot]
        cache_c[ln], cache_d[ln], cache_q[ln] = (
            case.colors[slot], case.depths[slot], case.inv_q[slot])
    cache_c[scratch_line], cache_d[scratch_line] = pkt.color_u8, \
        pkt.depth_u16
    cache_q[scratch_line] = pkt.depth_inv_q

    jmap = jmapper.make_window_frame_mapper(
        case.cfg, pair.jscene, pair.jcam, case.w_max, importance=False)
    opt_buf = jmap.jit_init({"map": pair.jms, "poses": jnp.zeros(
        (case.w_max, 7), jnp.float32)})
    jms, _, jest, jkf_est, jkf_gt, jlosses = jmap(
        pair.jms, opt_buf, jnp.asarray(case.est), jnp.asarray(case.kf_est),
        jnp.asarray(case.kf_gt), jslot_kf, jn_slots, jpose_mask,
        jnp.asarray(cache_c), jnp.asarray(cache_d), jnp.asarray(cache_q),
        jnp.asarray(win_lines), jnp.asarray(pkt.gt_c2w), IDX,
        len(KEYFRAMES), case.key, iters=case.iters, lr_factor=1.0,
        joint_opt=True, admit=True)

    store = tkf.KeyframeStore(CAPACITY, pair.cam, "cpu", mode="host_staged")
    store.init_cache(LINES)
    store.cache_colors[:] = torch.from_numpy(cache_c)
    store.cache_depths[:] = torch.from_numpy(cache_d)
    store.cache_inv_q[:] = torch.from_numpy(cache_q)
    store.est_c2w[:] = torch.tensor(case.kf_est)
    store.gt_c2w[:] = torch.tensor(case.kf_gt)
    store.count = len(KEYFRAMES)
    window_map = tmapper.make_window_frame_mapper(
        case.cfg, pair.scene, pair.cam, case.w_max, importance=False)
    replay = ReplayDraws(case.iteration_draws())
    est = torch.tensor(case.est)
    losses = window_map(
        pair.ms, store, est, torch.tensor(np.array(jslot_kf)).long(),
        torch.tensor(n_win), torch.tensor(np.array(jpose_mask)),
        torch.from_numpy(win_lines).long(), torch.tensor(pkt.gt_c2w), IDX,
        replay, iters=case.iters, lr_factor=1.0, joint_opt=True,
        admit=True)
    assert len(replay) == 0

    check_window(case, pair, losses, jlosses, jms, store.est_c2w, jkf_est,
                 est, jest, jslot_kf, jn_slots)
    np.testing.assert_array_equal(N(store.gt_c2w), np.asarray(jkf_gt))
    np.testing.assert_allclose(N(store.est_c2w[len(KEYFRAMES)]),
                               np.asarray(jest)[IDX], atol=3e-6)


# -- (c) the line cache ----------------------------------------------------


def assert_same_cache(st, jst):
    np.testing.assert_array_equal(st.line_of_slot, jst.line_of_slot)
    np.testing.assert_array_equal(st.slot_of_line, jst.slot_of_line)
    assert st.cache_misses == jst.cache_misses
    np.testing.assert_array_equal(N(st.cache_colors),
                                  np.asarray(jst.cache_colors))
    np.testing.assert_array_equal(N(st.cache_depths),
                                  np.asarray(jst.cache_depths))
    np.testing.assert_array_equal(N(st.cache_inv_q),
                                  np.asarray(jst.cache_inv_q))


def both(st, jst, op, *args):
    """Apply ``op`` to both stores; the same return value or the same
    RuntimeError."""
    out = []
    for s in (st, jst):
        try:
            out.append(getattr(s, op)(*args))
        except RuntimeError as e:
            out.append(f"RuntimeError: {e}")
    if isinstance(out[1], str) or isinstance(out[0], str):
        assert out[0] == out[1]
    else:
        np.testing.assert_array_equal(np.asarray(out[0]),
                                      np.asarray(out[1]))
    assert_same_cache(st, jst)
    return out[0]


def test_line_cache_matches_jax():
    cam = Camera(H=8, W=8, fx=4.0, fy=4.0, cx=3.5, cy=3.5)
    jcam = JCamera(H=8, W=8, fx=4.0, fy=4.0, cx=3.5, cy=3.5)
    cap = 16
    st = tkf.KeyframeStore(cap, cam, "cpu", mode="host_staged")
    jst = jkf.KeyframeStore(cap, jcam, device="host_staged")
    st.init_cache(4)  # 3 usable lines + scratch
    jst.init_cache(4)
    assert_same_cache(st, jst)
    rng = np.random.default_rng(0)

    def frame():
        return (rng.integers(0, 255, (8, 8, 3), np.uint8),
                rng.integers(0, 1000, (8, 8), np.uint16))

    for s in range(5):
        c, d = frame()
        both(st, jst, "add_host", s, c, d, 1e-3 * (s + 1))

    for got, ref in zip(st.window_imagery([3, 0, 4]),
                        jst.window_imagery([3, 0, 4])):
        np.testing.assert_array_equal(N(got), ref)

    # The sequence of test_host_cache_lru_unit.
    l0 = both(st, jst, "stage_lines", [0, 1, 2])
    assert st.cache_misses == 3
    np.testing.assert_array_equal(both(st, jst, "stage_lines", [0, 1, 2]),
                                  l0)
    assert st.cache_misses == 3
    (l3,) = both(st, jst, "stage_lines", [3])
    assert st.cache_misses == 4 and st.slot_of_line[l3] == 3
    c, d = frame()
    assert both(st, jst, "stage_scratch", c, d, 7e-3) == st.scratch_line
    pos = both(st, jst, "add_host", 99, c, d, 7e-3)
    both(st, jst, "bind_scratch", pos)
    ln = st.line_of_slot[pos]
    assert ln >= 0 and ln != st.scratch_line
    # Pinning more slots than usable lines fails loudly in both.
    assert "host_cache_lines" in both(st, jst, "stage_lines", [0, 1, 2, 3])

    # 40 random steps: windows of 1-4 slots (4 overflow the 3 lines) and
    # admissions through the scratch line.
    raised = 0
    for _ in range(40):
        if rng.random() < 0.3 and st.count < cap - 1:
            c, d = frame()
            q = float(rng.uniform(1e-4, 1e-2))
            both(st, jst, "stage_scratch", c, d, q)
            pos = both(st, jst, "add_host", int(rng.integers(1000)), c, d,
                       q)
            both(st, jst, "bind_scratch", pos)
        else:
            k = int(rng.integers(1, 5))
            slots = rng.choice(st.count, size=k, replace=False)
            out = both(st, jst, "stage_lines", slots)
            raised += isinstance(out, str)
    assert raised > 0 and st.cache_misses > 10


# -- (d) the host store's hull and select_window -----------------------------


def test_host_store_hull_points_match_jax():
    from test_torch_mesh import small_cfg as mesh_cfg

    cfg = mesh_cfg()
    cfg["meshing"]["bound_min_votes"] = 3
    cam, jcam = Camera.from_cfg(cfg), JCamera.from_cfg(cfg)
    from myslam_torch.utils.datasets import get_dataset

    ds = get_dataset(cfg)
    st = tkf.KeyframeStore(6, cam, "cpu", mode="host_staged")
    jst = jkf.KeyframeStore(6, jcam, device="host_staged")
    for slot, f in enumerate((0, 13, 26, 39)):
        color, depth, c2w = ds.get_frame(f)
        depth = depth.copy()
        depth[::7, ::5] = 0.0  # holes
        c, d, q = quantize(color, depth)
        st.add_host(f, c, d, q)
        jst.add_host(f, c, d, q)
        st.est_c2w[slot] = torch.tensor(c2w)
        jst.est_c2w = jst.est_c2w.at[slot].set(c2w)
    pts = mesher.backproject_keyframes(st, cam)
    jpts = jmesher.backproject_keyframes(jst, jcam)
    assert pts.shape == jpts.shape and len(pts) > 100
    np.testing.assert_allclose(pts, jpts, atol=1e-6, rtol=0)
    for min_votes in (1, 3, 8):
        got = mesher.denoise_observed_points(pts, 4, min_votes=min_votes)
        ref = jmesher.denoise_observed_points(jpts, 4, min_votes=min_votes)
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert len(mesher.denoise_observed_points(pts, 4, min_votes=8)) < len(
        pts)


@pytest.mark.parametrize("method", ["overlap", "global"])
def test_select_window_matches_jax(method):
    cam = Camera(H=8, W=8, fx=4.0, fy=4.0, cx=3.5, cy=3.5)
    jcam = JCamera(H=8, W=8, fx=4.0, fy=4.0, cx=3.5, cy=3.5)
    scores = np.array([0.3, 0.0, 0.5, 0.2, 0.0, 0.1, 0.7, 0.4, 0.9, 0.6,
                       -1, -1], np.float32)
    st = tkf.KeyframeStore(12, cam, "cpu", mode="packed")
    jst = jkf.KeyframeStore(12, jcam, device="packed")
    for count in (0, 1, 2, 3, 7, 11):
        st.count = jst.count = count
        for window in (1, 3, 5, 20):
            got = tkf.select_window(
                np.random.default_rng(count), lambda *a: torch.tensor(
                    scores), st, None, None, window, None, method)
            ref = jkf.select_window(
                np.random.default_rng(count), lambda *a: scores, jst, None,
                None, window, None, method)
            assert got == ref
