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


def mapper_case(cfg, spec, map_np, inputs, draws, iters, sharded):
    """engine/mapper.make_mapper on this rank: (poses, losses, map)."""
    import torch

    from myslam_torch.core.sampling import ReplayDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.engine.mapper import make_mapper
    from myslam_torch.parallel import distributed

    distributed.reset_counts()
    ms = _map(map_np)
    step = make_mapper(cfg, _scene(spec), Camera.from_cfg(cfg),
                       importance=spec["importance"], sharded=sharded)
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    replay = ReplayDraws(draws)
    poses, losses = step(ms, t["poses"], t["pose_mask"], t["slot_kf"],
                         int(inputs["n_slots"]), t["kf_colors"],
                         t["kf_depths"], replay, iters=iters, lr_factor=1.0)
    return {"poses": poses.numpy(), "losses": losses.numpy(),
            "map": _map_out(ms), "left": len(replay), "counts": _counts()}


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


def kf_ba_case(cfg, spec, map_np, inputs, local, draws, iters, solver):
    """parallel/distributed_ba.make_distributed_ba on this rank's own
    slots (``local``: rank -> (colors, depths))."""
    import torch

    from myslam_torch.core.sampling import ReplayDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.parallel import distributed
    from myslam_torch.parallel.distributed_ba import make_distributed_ba

    distributed.reset_counts()
    ms = _map(map_np)
    step = make_distributed_ba(cfg, _scene(spec), Camera.from_cfg(cfg),
                               iters=iters, pose_solver=solver)
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


def host_staged_refusal():
    """SLAMSystem with the host-staged store under ray DP: the error."""
    import tempfile

    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    cfg = load_config("configs/Synthetic/room_smoke.yaml", DEFAULT_CONFIG)
    cfg["data"]["n_frames"] = 2
    cfg["keyframe_device"] = "host_staged"
    cfg["parallel"]["devices"] = 0
    try:
        SLAMSystem(cfg, output=tempfile.mkdtemp(), device="cpu")
    except ValueError as e:
        return str(e)
    return "ran"


def kf_frame_case(cfg, spec, map_np, store_np, packets, draws, iters,
                  solver):
    """parallel/distributed_ba.make_kf_frame_mapper on this rank over a
    store sharded over the ranks (each rank fills its own slots), one
    call per packet in order (each admitted at the store's count), all
    from one replayed draw list: per frame the losses, the trajectory
    and the store's poses; at the end the map and this rank's
    imagery."""
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
