"""The host-staged keyframe store under ray DP (ROADMAP A2, repairs C3),
on 2 gloo ranks.

  * (c) ``make_window_frame_mapper(sharded=True)``, the mapper of the
    host-staged store, against JAX's ``make_window_frame_mapper(
    ray_sharding=...)`` on 2 virtual devices (``mapper.py:651-720``): a
    window of three keyframes of the room at 24x32 in the wire format,
    read from cache lines that are not their slots, frame 3 the current
    one 1 cm off, three iterations with jitter, joint poses, admission.
    JAX hands this mapper its ray sharding under either ``dp_impl``, so
    its draws are one device's (``map_iteration_draws``) and its
    gradient the exact global one: no doubled loss weights.  The gang
    runs it with the replicated Adam and with the row-sharded one
    (``min_rows`` 256: both atlases sharded), which agree bit for bit.
  * (d) ``SLAMSystem`` with ``keyframe_device: host_staged`` and
    ``parallel.devices: 0`` on a gang of 2 (test_torch_pipeline.py's
    24x32 room, 5 frames, frames 0 and 4 mapped): every rank holds the
    whole host store and cache, selects the same window and stages the
    same lines, so the ranks agree bit for bit, every bound cache line
    holds its host slot, one selection fetch per mapped frame; and the
    run stays within ``ONE_RANK_GATE_M`` per frame of the port's single
    rank.

Both run on one gang of 2 ranks (``gang``, shared by the module).
Tolerances: against JAX losses rtol 1e-5, poses atol 1e-5, the map as
``assert_map`` (test_torch_parallel.py).  The loop's gang against one
rank: 5e-5 m per frame (``ONE_RANK_GATE_M``): the two ranks' partial
sums reassociate the gradient's and the losses' sums, and tracking feeds
the difference back; measured 7.4e-6 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import NamedSharding, PartitionSpec as P

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.engine import mapper as jmapper
from test_torch_parallel import assert_map, fresh, map_np, mesh, spec_of
from test_torch_pipeline import config, one_process
from test_torch_slice import Pair, map_iteration_draws, small_cfg
from test_torch_store import quantize
from torch_gang import each, run_ranks, system_case, window_case

torch.set_num_threads(2)  # several test workers share the CPU

ITERS = 3
IDX = 3
CAP = 4  # keyframe slots 0-2, the scratch slot 3
LINE_OF_SLOT = np.array([2, 0, 3])
LINES = 5  # the scratch line last
MIN_ROWS = 256
ONE_RANK_GATE_M = 5e-5


@pytest.fixture(autouse=True)
def _scatter_route(monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)


def window_inputs():
    """(c)'s case: the scene pair, the cache, the window, the draws."""
    cfg = small_cfg(perturb=True)
    pair = Pair(cfg)
    cam = pair.cam
    rng = np.random.default_rng(3)
    colors = np.zeros((LINES, cam.H, cam.W, 3), np.uint8)
    depths = np.zeros((LINES, cam.H, cam.W), np.uint16)
    inv_q = np.ones((LINES,), np.float32)
    kf_est = np.tile(np.eye(4, dtype=np.float32), (CAP, 1, 1))
    for slot in range(3):
        c, d, gt = pair.dataset.get_frame(slot)
        ln = LINE_OF_SLOT[slot]
        colors[ln], depths[ln], inv_q[ln] = quantize(c, d)
        kf_est[slot] = gt
        kf_est[slot, :3, 3] += rng.normal(scale=0.004, size=3)
    pkt = pair.packet(IDX, need_full=True)
    colors[-1], depths[-1], inv_q[-1] = (pkt.color_u8, pkt.depth_u16,
                                         pkt.depth_inv_q)
    est = np.stack([pair.dataset.poses[f] for f in range(5)]).astype(
        np.float32)
    est[IDX, :3, 3] += 0.01
    key = jax.random.PRNGKey(11)
    draws = [np.asarray(d) for it in range(ITERS)
             for d in map_iteration_draws(key, it, 128, pair.jcam,
                                          pair.jscene, False)]
    inputs = {"kf_est": kf_est, "count": 3,
              "slot_kf": np.array([0, 1, 2, CAP - 1, CAP - 1], np.int64),
              "n_slots": 4,
              "pose_mask": np.array([0, 1, 1, 1, 0], np.float32),
              "win_lines": np.array([*LINE_OF_SLOT, LINES - 1, LINES - 1],
                                    np.int64),
              "gt_c2w": pkt.gt_c2w, "idx": IDX, "est": est}
    cache = {"colors": colors, "depths": depths, "inv_q": inv_q}
    return cfg, pair, cache, inputs, draws, key


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """One gang of 2 ranks: (c)'s window mapper with the replicated and
    the row-sharded Adam, then (d)'s loop."""
    tmp = tmp_path_factory.mktemp("dp_host")
    cfg, pair, cache, inputs, draws, key = window_inputs()
    path = config(tmp, 5, {"devices": 0})
    with open(path) as f:
        loop_cfg = yaml.safe_load(f)
    loop_cfg["keyframe_device"] = "host_staged"
    with open(path, "w") as f:
        yaml.safe_dump(loop_cfg, f)
    args = (cfg, spec_of(pair), map_np(pair), cache, inputs, draws, ITERS,
            True)
    outs = run_ranks(each, 2, [(window_case, args),
                               (window_case, args + (MIN_ROWS,)),
                               (system_case, (path, str(tmp / "gang")))],
                     timeout=240)
    return {"pair": pair, "cache": cache, "inputs": inputs, "key": key,
            "outs": outs, "path": path, "loop_cfg": loop_cfg, "tmp": tmp}


def test_window_mapper_matches_jax_on_two_ranks(gang):
    """(c) The host-staged store's window mapper on 2 ranks (replicated
    and row-sharded Adam) against JAX's on 2 devices: the losses, the
    map, the trajectory and the window's poses written back to their
    global slots."""
    pair, cache, inputs = gang["pair"], gang["cache"], gang["inputs"]
    w_max = inputs["slot_kf"].shape[0]
    jmap = jmapper.make_window_frame_mapper(
        pair.cfg, pair.jscene, pair.jcam, w_max, importance=False,
        ray_sharding=NamedSharding(mesh("dp"), P("dp")))
    opt_buf = jmap.jit_init({"map": pair.jms, "poses": jnp.zeros(
        (w_max, 7), jnp.float32)})
    est, kf_est = inputs["est"], inputs["kf_est"]
    jms, _, jest, jkf_est, _, jlosses = jmap(
        fresh(pair), opt_buf, jnp.asarray(est), jnp.asarray(kf_est),
        jnp.asarray(kf_est), jnp.asarray(inputs["slot_kf"], jnp.int32),
        jnp.int32(inputs["n_slots"]), jnp.asarray(inputs["pose_mask"]),
        jnp.asarray(cache["colors"]), jnp.asarray(cache["depths"]),
        jnp.asarray(cache["inv_q"]),
        jnp.asarray(inputs["win_lines"], jnp.int32),
        jnp.asarray(inputs["gt_c2w"]), IDX, inputs["count"], gang["key"],
        iters=ITERS, lr_factor=1.0, joint_opt=True, admit=True)
    outs = [rank[:2] for rank in gang["outs"]]
    for repl, zero in outs:
        for out in (repl, zero):
            assert out["left"] == 0
            for k in ("losses", "est", "kf_est"):
                np.testing.assert_array_equal(out[k], outs[0][0][k])
            for k in ("sdf_atlas", "color_atlas"):
                np.testing.assert_array_equal(out["map"][k],
                                              outs[0][0]["map"][k])
        assert repl["counts"]["grad"]["calls"] == ITERS
        assert repl["counts"]["loss"]["calls"] == ITERS
        assert zero["counts"]["grad_rs"]["calls"] == ITERS
        assert zero["counts"]["grad"]["calls"] == ITERS
        assert zero["counts"]["zero_gather"]["calls"] == ITERS
    got = outs[0][0]
    np.testing.assert_allclose(got["losses"], np.asarray(jlosses),
                               rtol=1e-5)
    assert_map(got["map"], jms)
    np.testing.assert_allclose(got["est"], np.asarray(jest), atol=1e-5)
    np.testing.assert_allclose(got["kf_est"], np.asarray(jkf_est),
                               atol=1e-5)
    assert np.abs(got["est"][IDX] - est[IDX]).max() > 1e-5


def test_host_staged_store_under_ray_dp(gang):
    """(d) The loop with the host-staged store on 2 ranks: ranks bit for
    bit (trajectory, map, host imagery), cache lines equal to their host
    slots, one selection fetch per mapped frame, one gradient all-reduce
    per mapping iteration, and within ONE_RANK_GATE_M of one rank."""
    outs = [rank[2] for rank in gang["outs"]]
    ref = one_process(gang["path"], gang["tmp"] / "one")
    m = gang["loop_cfg"]["mapping"]
    its = int(m["iters_first"]) + int(m["iters"])
    for out in outs:
        np.testing.assert_array_equal(out["est"], outs[0]["est"])
        for k in ("sdf_atlas", "color_atlas"):
            np.testing.assert_array_equal(out["map"][k],
                                          outs[0]["map"][k])
        host = out["host"]
        assert host["count"] == ref.store.count == 2
        assert host["selection_fetches"] == ref.selection_fetches == 2
        assert host["bound_lines"] >= host["count"]
        np.testing.assert_array_equal(host["colors_u8"],
                                      ref.store.colors_u8.numpy())
        assert out["counts"]["grad"]["calls"] == its
    d = np.linalg.norm(outs[0]["est"][:, :3, 3] - ref.estimates[:, :3, 3],
                       axis=-1)
    assert d.max() < ONE_RANK_GATE_M, d
