"""Run a function on a gang of CPU ranks for the port's tests.

``run_ranks(fn, world, *args)`` starts ``world`` spawned processes, each
joining one gloo process group (``myslam_torch.parallel.distributed``)
and calling ``fn(*args)``; it returns their results in rank order.  Each
gang runs under its own wall-clock limit: a rank that fails or a gang
that outlives the limit kills every rank and raises, so a hung
collective fails one test.  This module imports no JAX (the ranks do
not need it); the case functions below are what the tests run on the
ranks.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback

import numpy as np


def _rank_main(fn, rank, world, port, args, out):
    import torch

    from myslam_torch.parallel import distributed

    torch.set_num_threads(1)
    try:
        distributed.init_distributed(f"127.0.0.1:{port}", world, rank,
                                     "cpu", timeout_s=60)
        result = fn(*args)
        out.put((rank, "ok", result))
    except Exception:
        out.put((rank, "error", traceback.format_exc()))
    finally:
        distributed.shutdown()


def run_ranks(fn, world: int, *args, timeout: float = 120.0) -> list:
    """fn(*args) on each of ``world`` gloo ranks; their results."""
    from myslam_torch.parallel.multiproc import free_port

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.time() + timeout
    try:
        while len(results) < world:
            try:
                rank, status, value = out.get(timeout=1.0)
            except queue.Empty:
                if time.time() > deadline:
                    raise TimeoutError(f"gang past its {timeout} s limit")
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died")
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


# -- cases run on the ranks ---------------------------------------------------

def each(cases):
    """Several cases on one gang, in order: ``cases`` is a list of
    (fn, args); returns their results."""
    return [fn(*args) for fn, args in cases]


def _counts():
    from myslam_torch.parallel import distributed

    return {k: dict(v) for k, v in distributed.COUNTS.items()}


def _scene(spec):
    from myslam_torch.models.planes import make_layout
    from myslam_torch.render.renderer import SceneGeometry

    bound = np.asarray(spec["bound"], np.float32)
    c = spec["c_dim"]
    return SceneGeometry(
        sdf_layout=make_layout(bound, spec["sdf_res"], c),
        color_layout=make_layout(bound, spec["color_res"], c),
        bound=tuple(map(tuple, bound.tolist())),
        truncation=spec["truncation"], n_stratified=spec["n_stratified"],
        n_importance=spec["n_importance"], perturb=spec["perturb"],
        color_topk=spec["color_topk"])


def _map(map_np):
    from myslam_torch.models.convert import from_jax_numpy

    return from_jax_numpy(map_np)


def _map_out(ms):
    from myslam_torch.models.convert import to_jax_numpy

    return to_jax_numpy(ms)


def mapper_case(cfg, spec, map_np, inputs, draws, iters, sharded,
                spmd=False, min_rows=None):
    """engine/mapper.make_mapper on this rank: (poses, losses, map);
    ``spmd`` draws, and with ``min_rows`` the row-sharded Adam over the
    atlases of at least that many rows (its moments' bytes returned)."""
    import torch

    from myslam_torch.core.sampling import ReplayDraws
    from myslam_torch.engine import mapper
    from myslam_torch.engine.camera import Camera
    from myslam_torch.parallel import distributed

    distributed.reset_counts()
    mapper.ADAM_BYTES.update(atlas_moments=0, atlas_moments_replicated=0)
    ms = _map(map_np)
    step = mapper.make_mapper(
        cfg, _scene(spec), Camera.from_cfg(cfg),
        importance=spec["importance"], sharded=sharded, spmd=spmd,
        zero_opt=min_rows is not None, min_rows=min_rows or 0)
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    replay = ReplayDraws(draws)
    poses, losses = step(ms, t["poses"], t["pose_mask"], t["slot_kf"],
                         int(inputs["n_slots"]), t["kf_colors"],
                         t["kf_depths"], replay, iters=iters, lr_factor=1.0)
    return {"poses": poses.numpy(), "losses": losses.numpy(),
            "map": _map_out(ms), "left": len(replay), "counts": _counts(),
            "adam_bytes": dict(mapper.ADAM_BYTES)}


def reduce_rows_case(shapes, min_rows, seed):
    """distributed.reduce_grads_rows on this rank's random gradients of
    parameters of ``shapes`` (2-D ones of at least ``min_rows`` rows
    row-sharded), with the gradients and the collectives."""
    import torch

    from myslam_torch.parallel import distributed

    distributed.reset_counts()
    gen = torch.Generator().manual_seed(seed + distributed.rank())
    params = [torch.zeros(s, requires_grad=True) for s in shapes]
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen)
    sharded = [p.dim() == 2 and p.shape[0] >= min_rows for p in params]
    rs = distributed.reduce_grads_rows(params, sharded)
    return {"rs": [t.numpy() for t in rs],
            "grads": [p.grad.numpy() for p in params], "sharded": sharded,
            "counts": _counts()}


def minislam_case(mode, frames, replay, overrides):
    """parallel/multiproc.run_minislam on this rank from the ``replay``
    file (the map and the draws), the config merged with
    ``overrides``."""
    from myslam_torch.parallel import multiproc

    return multiproc.run_minislam(mode, frames, 0, "cpu", replay, overrides,
                                  log=lambda m: None)


def tracker_case(cfg, spec, map_np, inputs, draws):
    """engine/tracker.make_tracker, sharded over the ranks."""
    import torch

    from myslam_torch.core.sampling import ReplayDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.engine.tracker import make_tracker
    from myslam_torch.parallel import distributed

    distributed.reset_counts()
    track = make_tracker(cfg, _scene(spec), Camera.from_cfg(cfg),
                         sharded=True)
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    replay = ReplayDraws(draws)
    best, losses, iter_poses = track(
        _map(map_np), t["pose_init"], t["px_i"], t["px_j"], t["px_color"],
        t["px_depth"], replay)
    return {"best": best.numpy(), "losses": losses.numpy(),
            "iter_poses": iter_poses.numpy(), "left": len(replay),
            "counts": _counts()}


def kf_ba_case(cfg, spec, map_np, inputs, local, draws, iters, solver,
               schur_interval=1):
    """parallel/distributed_ba.make_distributed_ba on this rank's own
    slots (``local``: rank -> (colors, depths)), solving on every
    ``schur_interval``-th iteration under schur."""
    import torch

    from myslam_torch.core.sampling import ReplayDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.parallel import distributed
    from myslam_torch.parallel.distributed_ba import make_distributed_ba

    distributed.reset_counts()
    ms = _map(map_np)
    step = make_distributed_ba(cfg, _scene(spec), Camera.from_cfg(cfg),
                               iters=iters, pose_solver=solver,
                               schur_interval=schur_interval)
    colors, depths = (torch.as_tensor(a) for a in
                      local[distributed.rank()])
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    replay = ReplayDraws(draws)
    poses, losses = step(ms, t["poses"], t["pose_mask"], t["slot_kf"],
                         int(inputs["n_slots"]), (colors, depths, None),
                         colors.shape[0], replay)
    return {"poses": poses.numpy(), "losses": losses.numpy(),
            "map": _map_out(ms), "left": len(replay), "counts": _counts()}


def pose_system_case(cfg, spec, map_np, poses, per_rank):
    """The reduced pose system of this rank's rays, summed over ranks."""
    import torch

    from myslam_torch.engine.camera import Camera
    from myslam_torch.parallel import distributed
    from myslam_torch.parallel.distributed_ba import make_pose_system

    system = make_pose_system(cfg, _scene(spec), Camera.from_cfg(cfg),
                              exact_color=spec["exact_color"])
    r = per_rank[distributed.rank()]
    H, g = system(_map(map_np), torch.as_tensor(poses),
                  torch.as_tensor(r["p"]), torch.as_tensor(r["i"]),
                  torch.as_tensor(r["j"]), torch.as_tensor(r["px_depth"]),
                  torch.as_tensor(r["px_color"]),
                  torch.as_tensor(r["z_vals"]),
                  torch.as_tensor(r["valid"]))
    return {"H": H.numpy(), "g": g.numpy()}


def window_case(cfg, spec, map_np, cache_np, inputs, draws, iters,
                sharded, min_rows=None):
    """engine/mapper.make_window_frame_mapper on this rank over a
    host-staged store whose line cache holds ``cache_np`` (with
    ``min_rows`` the row-sharded Adam): the losses, the map, the
    trajectory and the store's poses."""
    import torch

    from myslam_torch.core.sampling import ReplayDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.engine.keyframes import KeyframeStore
    from myslam_torch.engine.mapper import make_window_frame_mapper
    from myslam_torch.parallel import distributed

    distributed.reset_counts()
    cam = Camera.from_cfg(cfg)
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    store = KeyframeStore(t["kf_est"].shape[0], cam, "cpu",
                          mode="host_staged")
    store.init_cache(cache_np["colors"].shape[0])
    with torch.no_grad():
        store.cache_colors.copy_(torch.as_tensor(cache_np["colors"]))
        store.cache_depths.copy_(torch.as_tensor(cache_np["depths"]))
        store.cache_inv_q.copy_(torch.as_tensor(cache_np["inv_q"]))
        store.est_c2w.copy_(t["kf_est"])
        store.gt_c2w.copy_(t["kf_est"])
    store.count = int(inputs["count"])
    w_max = t["slot_kf"].shape[0]
    window_map = make_window_frame_mapper(
        cfg, _scene(spec), cam, w_max, importance=spec["importance"],
        sharded=sharded, zero_opt=min_rows is not None,
        min_rows=min_rows or 0)
    ms = _map(map_np)
    est = t["est"].clone()
    replay = ReplayDraws(draws)
    idx = int(inputs["idx"])
    losses = window_map(ms, store, est, t["slot_kf"],
                        torch.tensor(int(inputs["n_slots"])),
                        t["pose_mask"], t["win_lines"], t["gt_c2w"], idx,
                        replay, iters=iters, lr_factor=1.0, joint_opt=True,
                        admit=True)
    return {"losses": losses.numpy(), "map": _map_out(ms),
            "est": est.numpy(), "kf_est": store.est_c2w.numpy(),
            "left": len(replay), "counts": _counts()}


def kf_frame_case(cfg, spec, map_np, store_np, packets, draws, iters,
                  solver):
    """parallel/distributed_ba.make_kf_frame_mapper on this rank over a
    store sharded over the ranks (each rank fills its own slots), one
    call per packet in order (each admitted at the store's count), all
    from one replayed draw list: per frame the losses, the trajectory
    and the store's poses; at the end the map and this rank's imagery."""
    import torch

    from myslam_torch.core.sampling import ReplayDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.engine.keyframes import KeyframeStore, \
        make_window_selector
    from myslam_torch.parallel import distributed
    from myslam_torch.parallel.distributed_ba import make_kf_frame_mapper

    distributed.reset_counts()
    cam = Camera.from_cfg(cfg)
    cap, w_max = store_np["colors"].shape[0], spec["w_max"]
    store = KeyframeStore(cap, cam, "cpu",
                          shard=(distributed.rank(), distributed.world()))
    lo = store.slot_offset
    with torch.no_grad():
        store.colors.copy_(torch.as_tensor(
            store_np["colors"][lo:lo + store.local_capacity]))
        store.depths.copy_(torch.as_tensor(
            store_np["depths"][lo:lo + store.local_capacity]))
        store.est_c2w.copy_(torch.as_tensor(store_np["est_c2w"]))
        store.gt_c2w.copy_(torch.as_tensor(store_np["gt_c2w"]))
    store.count = int(store_np["count"])
    selector = make_window_selector(cam, cap, spec["window_size"], w_max,
                                    cap - 1)
    mapper = make_kf_frame_mapper(cfg, _scene(spec), cam, selector, w_max,
                                  cap - 1, importance=False,
                                  pose_solver=solver)
    ms = _map(map_np)
    est = torch.as_tensor(store_np["est"]).clone()
    replay = ReplayDraws(draws)
    out = {"losses": [], "est": [], "kf_est": []}
    for packet in packets:
        losses = mapper(ms, store, est, torch.as_tensor(packet["color_u8"]),
                        torch.as_tensor(packet["depth_u16"]),
                        float(packet["inv_q"]),
                        torch.as_tensor(packet["gt_c2w"]),
                        int(packet["idx"]), replay, iters=iters,
                        lr_factor=1.0, joint_opt=True, admit=True)
        store.note_admitted(False, int(packet["idx"]))
        out["losses"].append(losses.numpy())
        out["est"].append(est.numpy().copy())
        out["kf_est"].append(store.est_c2w.numpy().copy())
    return {**out, "map": _map_out(ms), "colors": store.colors.numpy(),
            "depths": store.depths.numpy(), "slot_offset": lo,
            "left": len(replay), "counts": _counts()}


def gather_store_case(H, W, capacity, packed):
    """A store sharded over the ranks, each rank's slots filled with
    values of its own, then ``full_view()``: rank 0's imagery and the
    ranks' "store" collectives; None for the imagery elsewhere."""
    import torch

    from myslam_torch.engine.camera import Camera
    from myslam_torch.engine.keyframes import KeyframeStore
    from myslam_torch.parallel import distributed

    distributed.reset_counts()
    cam = Camera(H=H, W=W, fx=20.0, fy=20.0, cx=W / 2, cy=H / 2)
    me, world = distributed.rank(), distributed.world()
    store = KeyframeStore(capacity, cam, "cpu",
                          mode="packed" if packed else "device",
                          shard=(me, world))
    gen = torch.Generator().manual_seed(me)
    bufs = [b for b in store.imagery() if b is not None]
    with torch.no_grad():
        for buf in bufs:
            buf.copy_(torch.randint(0, 200, buf.shape, generator=gen)
                      .to(buf.dtype))
    mine = [b.numpy().copy() for b in bufs]
    full = store.full_view()
    return {"mine": mine, "counts": _counts(),
            "full": None if full is None else [
                b.numpy() for b in full.imagery() if b is not None]}


def sharded_frame_case(cfg, spec, map_np_, store_np, packet, draws, iters,
                       cap, window):
    """engine/mapper.make_frame_mapper over parallel/sharded_engine's
    banded map (``queries_factory``) on this rank for one frame over a
    ``cap``-slot store: the losses, the replicated map after unshard,
    the trajectory, the store's poses and the collectives."""
    import torch

    from myslam_torch.core.sampling import ReplayDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.engine.keyframes import KeyframeStore, \
        make_window_selector
    from myslam_torch.parallel import distributed
    from myslam_torch.engine.mapper import make_frame_mapper
    from myslam_torch.parallel.sharded_engine import ShardedMapGeometry

    distributed.reset_counts()
    cam = Camera.from_cfg(cfg)
    scene = _scene(spec)
    store = KeyframeStore(cap, cam, "cpu")
    with torch.no_grad():
        for name in ("colors", "depths", "est_c2w", "gt_c2w"):
            getattr(store, name).copy_(torch.as_tensor(store_np[name]))
    store.count = int(store_np["count"])
    w_max = window + 2
    selector = make_window_selector(cam, cap, window, w_max, cap - 1)
    geom = ShardedMapGeometry(scene, distributed.world(), distributed.rank())
    mapper = make_frame_mapper(cfg, scene, cam, selector, w_max, cap - 1,
                               importance=True,
                               queries_factory=geom.queries_factory)
    ms = _map(map_np_)
    banded = geom.shard(ms)
    est = torch.as_tensor(store_np["est"]).clone()
    replay = ReplayDraws(draws)
    losses = mapper(banded, store, est, torch.as_tensor(packet["color_u8"]),
                    torch.as_tensor(packet["depth_u16"]),
                    float(packet["inv_q"]), torch.as_tensor(packet["gt_c2w"]),
                    int(packet["idx"]), replay, iters=iters, lr_factor=1.0,
                    joint_opt=True, admit=True)
    geom.unshard(banded, into=ms)
    return {"losses": losses.numpy(), "map": _map_out(ms),
            "est": est.numpy(), "kf_est": store.est_c2w.numpy(),
            "band_rows": int(banded.sdf_atlas.shape[0]),
            "left": len(replay), "counts": _counts()}


def kfdp_frame_case(cfg, spec, map_np_, store_np, packet, draws, iters,
                    solver, grid, cap, window):
    """make_kf_frame_mapper(dp=D) on this rank of the ``grid`` (K, D),
    over a ``cap``-slot store sharded over the kf rows: the losses, the
    trajectory, the store's poses, the map, this row's imagery and the
    collectives."""
    import torch

    from myslam_torch.core.sampling import ReplayDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.engine.keyframes import KeyframeStore, \
        make_window_selector
    from myslam_torch.parallel import distributed
    from myslam_torch.parallel.distributed_ba import make_kf_frame_mapper

    distributed.reset_counts()
    K, D = grid
    cam = Camera.from_cfg(cfg)
    store = KeyframeStore(cap, cam, "cpu",
                          shard=(distributed.rank() // D, K))
    lo = store.slot_offset
    with torch.no_grad():
        store.colors.copy_(torch.as_tensor(
            store_np["colors"][lo:lo + store.local_capacity]))
        store.depths.copy_(torch.as_tensor(
            store_np["depths"][lo:lo + store.local_capacity]))
        store.est_c2w.copy_(torch.as_tensor(store_np["est_c2w"]))
        store.gt_c2w.copy_(torch.as_tensor(store_np["gt_c2w"]))
    store.count = int(store_np["count"])
    w_max = window + 2
    selector = make_window_selector(cam, cap, window, w_max, cap - 1)
    mapper = make_kf_frame_mapper(cfg, _scene(spec), cam, selector, w_max,
                                  cap - 1, importance=False,
                                  pose_solver=solver, dp=D)
    ms = _map(map_np_)
    est = torch.as_tensor(store_np["est"]).clone()
    replay = ReplayDraws(draws)
    losses = mapper(ms, store, est, torch.as_tensor(packet["color_u8"]),
                    torch.as_tensor(packet["depth_u16"]),
                    float(packet["inv_q"]),
                    torch.as_tensor(packet["gt_c2w"]), int(packet["idx"]),
                    replay, iters=iters, lr_factor=1.0, joint_opt=True,
                    admit=True)
    return {"losses": losses.numpy(), "est": est.numpy(),
            "kf_est": store.est_c2w.numpy(), "map": _map_out(ms),
            "colors": store.colors.numpy(), "slot_offset": lo,
            "left": len(replay), "counts": _counts()}


def system_case(config, out_dir, resume=False):
    """SLAMSystem's loop on the config file ``config`` on this rank,
    writing into ``out_dir`` (resumed from its newest checkpoint with
    ``resume``): the trajectory, the replicated map (None on the
    pipeline's track role, which holds a snapshot), where it started and
    the collectives."""
    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.parallel import distributed
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    distributed.reset_counts()
    slam = SLAMSystem(load_config(config, DEFAULT_CONFIG), output=out_dir,
                      device="cpu")
    start = slam.resume() if resume else 0
    slam.run(start, finalize=False)
    owns_map = slam.pipe is None or slam.pipe.is_map
    host = None
    if slam.store.host_mode:
        host = {"bound_lines": slam.store.check_cache(),
                "selection_fetches": slam.selection_fetches,
                "count": slam.store.count,
                "colors_u8": slam.store.colors_u8.numpy()}
    return {"est": slam.estimates, "start": start,
            "map": _map_out(slam.map_state) if owns_map else None,
            "role": None if slam.pipe is None else
            "map" if slam.pipe.is_map else "track",
            "counts": _counts(), "host": host}
