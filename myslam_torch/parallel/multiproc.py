"""The multi-process gang: its launcher, and the loops it runs.

The port of ``myslam_tpu/parallel/multiproc.py``.  ``launch(nproc, ...)``
starts ``nproc`` processes of this module, one rank each (one process,
one device: ``distributed.rank_device``), wires them into a process group
(``tcp://127.0.0.1:<free port>``), polls them, and on the first abnormal
exit kills the others and raises with that rank's output: a rank that
died leaves its peers waiting in a collective.  On a GPU the kernels are
built once, before the gang starts.  Each rank runs one of:

  * ``run_minislam(mode)``: a small deterministic loop (tracking, every
    second frame mapped and admitted) over the port's bare steps:
    ``mode="dp"`` ray data parallelism (``engine/mapper.make_mapper``),
    ``mode="kf"`` keyframe-sharded BA (``distributed_ba
    .make_distributed_ba``, each rank holding only its own slots);
    tracking splits its pixels over the ranks in both;
  * ``run_product(mode)``: ``SLAMSystem`` on ``product_cfg`` (packed
    store, chunked schedule, joint BA), then its final checkpoint
    resumed by a fresh system on the same gang;
  * ``run_system(config)``: ``SLAMSystem`` on a config file, the loop
    alone, with this rank's record (trajectory, frame times, kernel
    launches, collectives, peak memory, keyframe bytes);
  * ``run_validate(mode)``: a config whose parallel mode asks for fewer
    ranks than the gang has must be refused (``{"rejected": 1.0}``);
  * ``run_bigstep(mode)``: mapping chunks across the gang at the Replica
    operating point (680x1200 imagery, 4,000 rays, 15-iteration chunks,
    room-scale atlases, an 8-slot window): seconds per chunk and the
    peak RSS;
  * ``run_scaling_window()``: one mapping window of ``frames``
    iterations, ray DP with the replicated Adam and then under ``dp_impl:
    spmd`` with the row-sharded one, each one's collectives by kind
    (``tools/validate_scaling.py``);
  * ``run_pose_solver()``: ``tools/bench_pose_solver.py``'s adam and
    schur solvers at equal wall time over the gang's keyframe shards.

``product_cfg`` and ``run_product`` take the modes ``dp``, ``kf``,
``kfdp`` (2 kf rows x the rest as dp columns), ``map`` (banded map
shards over every rank) and ``pipeline`` (one tracking rank, the rest
mapping).  Every rank runs on its GPU (``distributed.rank_device``; it
raises where there is none) unless ``device="cpu"`` is given to
``launch`` and the loops.  Every rank writes its result to
``<out>/rank<r>.json``; ``launch`` returns them in rank order.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tiny_cfg(frames: int = 6, n_devices: int = 2,
             overrides: dict | None = None) -> dict:
    """The mini-loop's config: the synthetic room at 48x64, ray budgets
    of 16 per rank, 2 tracking and 4/2 mapping iterations, 8+4 samples,
    f32 quads in mapping (the JAX package's ``tiny_cfg``), then
    ``overrides`` merged in."""
    from myslam_torch.utils.config import load_config, update_recursive

    cfg = load_config(
        os.path.join(_REPO, "configs", "Synthetic", "room_smoke.yaml"),
        os.path.join(_REPO, "configs", "myslam.yaml"))
    update_recursive(cfg, {
        "data": {"n_frames": frames},
        "cam": {"H": 48, "W": 64, "fx": 40.0, "fy": 40.0,
                "cx": 31.5, "cy": 23.5},
        "tracking": {"pixels": 16 * n_devices, "iters": 2,
                     "ignore_edge_W": 4, "ignore_edge_H": 4},
        "mapping": {"pixels": 16 * n_devices, "iters_first": 4,
                    "iters": 2, "map_bf16": False},
        "rendering": {"n_stratified": 8, "n_importance": 4},
    })
    update_recursive(cfg, overrides or {})
    return cfg


def run_minislam(mode: str = "dp", frames: int = 6, seed: int = 0,
                 device=None, replay: str | None = None,
                 overrides: dict | None = None, log=print) -> dict:
    """The mini-loop over every rank of the process group (one rank runs
    it alone).  ``replay``: an npz holding the initial map (the
    checkpoint's ``sdf_atlas``, ``color_atlas``, ``decoder_leaves``) and
    the draws in call order (``draw_<k>``), which every rank replays;
    else the map and the draws come from ``seed``.  ``overrides``: merged
    into the config (``tiny_cfg``).  Returns
    {"est": (frames, 4, 4), "track_losses": (frames-1,), "map_losses":
    (mapped iterations,)}, the same on every rank."""
    import torch

    from myslam_torch.core.quaternion import cam_pose_to_matrix, \
        matrix_to_cam_pose
    from myslam_torch.core.sampling import ReplayDraws, TorchDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.engine.mapper import make_mapper
    from myslam_torch.engine.tracker import make_tracker
    from myslam_torch.models.config import get_model
    from myslam_torch.models.planes import compute_bound, init_map_state, \
        make_layout
    from myslam_torch.parallel import distributed
    from myslam_torch.parallel.distributed_ba import make_distributed_ba
    from myslam_torch.render.renderer import SceneGeometry
    from myslam_torch.utils.datasets import get_dataset
    from myslam_torch.utils.logger import restore_map

    dev = distributed.rank_device(distributed.rank(), device)
    world = distributed.world()
    cfg = tiny_cfg(frames, world, overrides)
    cam = Camera.from_cfg(cfg)
    bound = compute_bound(cfg)
    sdf_layout = make_layout(bound, [0.48, 0.24], 8)
    color_layout = make_layout(bound, [0.48, 0.24], 8)
    scene = SceneGeometry(sdf_layout, color_layout,
                          tuple(map(tuple, bound.tolist())), 0.06, 8, 4,
                          True)
    dataset = get_dataset(cfg)
    gen = torch.Generator().manual_seed(seed)
    ms = init_map_state(gen, sdf_layout, color_layout,
                        get_model({"model": {"c_dim": 8}}, gen), device=dev)
    if replay:
        with np.load(replay, allow_pickle=True) as f:
            restore_map(f, ms)
            draws = ReplayDraws([torch.as_tensor(f[f"draw_{k}"]).to(dev)
                                 for k in range(int(f["n_draws"]))])
    else:
        draws = TorchDraws(seed, dev)

    w_max = 4
    cap = -(-w_max // world) * world  # slots split evenly over the ranks
    m = cfg["mapping"]
    iters_first, iters = int(m["iters_first"]), int(m["iters"])
    sharded = world > 1
    if mode == "dp":
        mapper = make_mapper(cfg, scene, cam, sharded=sharded)
    elif mode == "kf":
        mappers = {it: make_distributed_ba(cfg, scene, cam, iters=it,
                                           pose_solver="adam")
                   for it in (iters_first, iters)}
    else:
        raise ValueError(f"unknown mode {mode!r}")
    tracker = make_tracker(cfg, scene, cam, sharded=sharded)
    slot_frames: list[int] = []

    def feed_keyframes():
        """The window imagery: replicated under dp; under kf each rank
        renders only its own slots (``host_shard``)."""
        lo, hi = (0, cap) if mode == "dp" else distributed.host_shard(cap)
        colors = np.zeros((hi - lo, cam.H, cam.W, 3), np.float16)
        depths = np.zeros((hi - lo, cam.H, cam.W), np.float32)
        for s in range(lo, min(hi, len(slot_frames))):
            c, d, _ = dataset.get_frame(slot_frames[s])
            colors[s - lo] = c.astype(np.float16)
            depths[s - lo] = d
        return torch.as_tensor(colors).to(dev), torch.as_tensor(depths).to(
            dev)

    def window():
        """The newest w_max slots; the oldest pose frozen."""
        slots = list(range(max(len(slot_frames) - w_max, 0),
                           len(slot_frames)))
        n_slots = len(slots)
        slot_kf = np.zeros((w_max,), np.int64)
        slot_kf[:n_slots] = slots
        c2ws = np.stack([est[slot_frames[s]] for s in slots]
                        + [np.eye(4, dtype=np.float32)] * (w_max - n_slots))
        pose_mask = np.zeros((w_max,), np.float32)
        if n_slots > 1:
            pose_mask[1:n_slots] = 1.0
        poses7 = matrix_to_cam_pose(torch.as_tensor(c2ws).to(dev))
        return slot_kf, n_slots, poses7, pose_mask, slots

    t = cfg["tracking"]
    it_n, n_px = int(t["iters"]), int(t["pixels"])
    ew, eh = int(t["ignore_edge_W"]), int(t["ignore_edge_H"])

    def track_pixels(f):
        rng = np.random.default_rng(seed * 1000 + f)
        i = rng.integers(ew, cam.W - ew, size=(it_n, n_px))
        j = rng.integers(eh, cam.H - eh, size=(it_n, n_px))
        color, depth, _ = dataset.get_frame(f)
        px_color = (color[j, i] * 255.0).astype(np.uint8)
        px_depth = depth[j, i].astype(np.float32)
        return [torch.as_tensor(a).to(dev) for a in (
            i.astype(np.float32), j.astype(np.float32), px_color, px_depth)]

    est = np.zeros((frames, 4, 4), np.float32)
    track_losses: list[float] = []
    map_losses: list[np.ndarray] = []
    for f in range(frames):
        if f == 0:
            est[0] = dataset.get_frame(0)[2]
        else:
            distributed.barrier()
            pose_init = matrix_to_cam_pose(
                torch.as_tensor(est[f - 1]).to(dev))
            best, tlosses, _ = tracker(ms, pose_init, *track_pixels(f),
                                       draws)
            est[f] = cam_pose_to_matrix(best[None])[0].cpu().numpy()
            track_losses.append(float(tlosses[-1]))
        if f % 2 == 0:
            distributed.barrier()
            slot_frames.append(f)
            kf_c, kf_d = feed_keyframes()
            slot_kf, n_slots, poses7, pose_mask, slots = window()
            it = iters_first if f == 0 else iters
            args = (ms, poses7, torch.as_tensor(pose_mask).to(dev),
                    torch.as_tensor(slot_kf).to(dev), n_slots)
            if mode == "dp":
                poses_out, losses = mapper(*args, kf_c, kf_d, draws,
                                           iters=it, lr_factor=1.0)
            else:
                poses_out, losses = mappers[it](*args, (kf_c, kf_d, None),
                                                cap // world, draws)
            map_losses.append(losses.cpu().numpy().ravel())
            c2ws_out = cam_pose_to_matrix(poses_out).cpu().numpy()
            for w, s in enumerate(slots):
                if pose_mask[w] > 0:
                    est[slot_frames[s]] = c2ws_out[w]
    distributed.barrier()
    if replay and len(draws):
        raise RuntimeError(f"{len(draws)} replayed draws left unused")
    out = {"est": est, "track_losses": np.asarray(track_losses),
           "map_losses": np.concatenate(map_losses)}
    log(f"minislam[{mode}] over {world} rank(s): final map loss "
        f"{out['map_losses'][-1]:.4f}")
    return out


# The ``parallel`` section of each product mode, over every rank of the
# gang (kfdp: 2 kf rows, its dp columns the rest; pipeline: one tracking
# rank, the rest mapping).
PRODUCT_PARALLEL = {
    "dp": {"devices": 0}, "kf": {"kf_shards": 0}, "map": {"map_shards": 0},
    "pipeline": {"pipeline": True, "pipeline_track_devices": 1,
                 "pipeline_map_devices": 0}}


def product_parallel(mode: str, world: int) -> dict:
    """The ``parallel`` section of product mode ``mode`` on ``world``
    ranks."""
    if mode == "kfdp":
        return {"kf_shards": 2, "devices": max(world // 2, 1)}
    if mode not in PRODUCT_PARALLEL:
        raise ValueError(f"unknown mode {mode!r}")
    return dict(PRODUCT_PARALLEL[mode])


def product_cfg(frames: int = 12, mode: str = "dp", size=(96, 128),
                world: int = 2) -> dict:
    """SLAMSystem's config for the product loop over the gang (the JAX
    package's ``product_cfg``): the synthetic room at ``size`` (H, W),
    the chunked 15-iteration schedule with a 31-iteration first frame,
    the packed keyframe store, admission every 4th frame, joint BA once
    more than 4 keyframes, no panels, f32 quads; the ``parallel``
    section of ``mode`` on ``world`` ranks (``product_parallel``)."""
    from myslam_torch.utils.config import load_config, update_recursive

    cfg = load_config(
        os.path.join(_REPO, "configs", "Synthetic", "room_smoke.yaml"),
        os.path.join(_REPO, "configs", "myslam.yaml"))
    H, W = size
    update_recursive(cfg, {
        "data": {"n_frames": frames},
        "cam": {"H": H, "W": W, "fx": 80.0 * W / 128, "fy": 80.0 * W / 128,
                "cx": (W - 1) / 2, "cy": (H - 1) / 2},
        "keyframe_device": "cpu",
        "tracking": {"pixels": 256, "iters": 8,
                     "ignore_edge_W": 8, "ignore_edge_H": 8,
                     "vis_freq": 10 ** 9},
        "mapping": {"pixels": 512, "iters_first": 31, "iters": 15,
                    "every_frame": 4, "keyframe_every": 4,
                    "mapping_window_size": 6, "vis_freq": 10 ** 9,
                    "map_bf16": False},
        "rendering": {"n_stratified": 24, "n_importance": 8},
    })
    cfg["parallel"] = product_parallel(mode, world)
    return cfg


def run_product(mode: str = "dp", frames: int = 12, seed: int = 0,
                device=None, size=(96, 128),
                log=print) -> dict:
    """SLAMSystem on ``product_cfg`` over the gang, its final checkpoint
    written, then a fresh SLAMSystem resumed from it on the same gang.
    Every rank has an output folder of its own, so only rank 0's holds
    the checkpoint: the resume must come from rank 0's decision.
    Returns {"est", "map_losses", "map_sum", "resume_ok",
    "resumed_from"}."""
    import torch

    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.parallel import distributed

    device = distributed.rank_device(distributed.rank(), device)
    cfg = product_cfg(frames, mode, size, distributed.world())
    out_dir = tempfile.mkdtemp(prefix=f"product_{mode}_")
    slam = SLAMSystem(cfg, output=out_dir, seed=seed, device=device)
    slam.mesh_freq = slam.ckpt_freq = 10 ** 9
    map_losses = []
    orig = slam._map_frame

    def record(idx, pkt, rec):
        orig(idx, pkt, rec)
        map_losses.append(float(rec["map_loss_first"]))
        map_losses.append(float(rec["map_loss_last"]))

    slam._map_frame = record
    slam.run(finalize=False)
    # The final checkpoint (under the pipeline, the map role's).
    slam.finalize(mesh=False)
    slam2 = SLAMSystem(cfg, output=out_dir, seed=seed, device=device)
    start = slam2.resume()
    # The map and the store are the map role's under the pipeline.
    owns_map = slam.pipe is None or slam.pipe.is_map
    with torch.no_grad():
        est_err = float(np.abs(slam2.estimates - slam.estimates).max())
        map_err = (float((slam2.map_state.sdf_atlas
                          - slam.map_state.sdf_atlas).abs().max())
                   if owns_map else 0.0)
        st = slam.store
        rows = (min(st.slot_offset + st.local_capacity, st.count)
                - min(st.slot_offset, st.count))
        store_err = max(
            [float((a[:rows].float() - b[:rows].float()).abs().max())
             for a, b in zip(slam2.store.imagery(), st.imagery())
             if a is not None and rows > 0 and owns_map] + [0.0])
    ok = (start == slam.n_img and slam2.store.count == slam.store.count
          and est_err == 0.0 and map_err == 0.0 and store_err == 0.0)
    out = {"est": slam.estimates, "map_losses": np.asarray(map_losses),
           "map_sum": float(slam.map_state.sdf_atlas.detach().abs().sum()),
           "resume_ok": float(ok), "resumed_from": start}
    log(f"product[{mode}] rank {slam.rank}/{slam.n_proc}: resumed at "
        f"{start}, ok {ok}")
    return out


def run_validate(mode: str = "kf", frames: int = 4, seed: int = 0,
                 device=None, log=print) -> dict:
    """SLAMSystem must refuse a config whose parallel mode asks for fewer
    ranks than the gang has (the JAX package's ``run_validate``: a mesh
    that does not span every process): ``kf_shards`` or ``devices`` of
    one rank, the devices one process holds.  Returns {"rejected": 1.0}
    when it raises naming the process group it needs, else 0.0."""
    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.parallel import distributed

    device = distributed.rank_device(distributed.rank(), device)
    cfg = product_cfg(frames, "kf" if mode == "kf" else "dp")
    cfg["parallel"] = ({"kf_shards": 1} if mode == "kf"
                       else {"devices": 1, "dp_impl": "shardmap"})
    try:
        SLAMSystem(cfg, output=tempfile.mkdtemp(prefix="val_"), seed=seed,
                   device=device)
    except ValueError as e:
        if "needs a process group" not in str(e):
            raise
        log(f"validate[{mode}]: undersized mode refused: {e}")
        return {"rejected": 1.0}
    log(f"validate[{mode}]: undersized mode was ACCEPTED")
    return {"rejected": 0.0}


def run_bigstep(mode: str = "dp", frames: int = 3, seed: int = 0,
                device=None, log=print) -> dict:
    """Mapping chunks across the gang at the Replica operating point (the
    JAX package's ``run_bigstep``): 680x1200 imagery, 4,000 rays in
    15-iteration chunks, room.yaml's atlases, an 8-slot window of random
    packed imagery dequantized once; ``mode`` dp (the bare mapper's ray
    DP) or kf (keyframe-sharded BA, each rank holding its own slots).
    ``frames`` chunks run, the first with the warm-up.  Returns
    {"chunk_s": [...], "rss_mb": peak RSS of this process, "losses"}."""
    import resource

    import torch

    from myslam_torch.core.quaternion import matrix_to_cam_pose
    from myslam_torch.core.sampling import TorchDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.engine.mapper import make_mapper
    from myslam_torch.models.config import get_model
    from myslam_torch.models.planes import compute_bound, init_map_state
    from myslam_torch.parallel import distributed
    from myslam_torch.parallel.distributed_ba import make_distributed_ba
    from myslam_torch.render.renderer import scene_from_cfg
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    dev = distributed.rank_device(distributed.rank(), device)
    world = distributed.world()
    cfg = load_config(os.path.join(_REPO, "configs", "Synthetic",
                                   "room.yaml"), DEFAULT_CONFIG)
    cfg["cam"].update(H=680, W=1200, fx=600.0, fy=600.0, cx=599.5,
                      cy=339.5)
    cfg["mapping"]["pixels"] = 4000
    cam = Camera.from_cfg(cfg)
    scene = scene_from_cfg(cfg)
    gen = torch.Generator().manual_seed(seed)
    ms = init_map_state(gen, scene.sdf_layout, scene.color_layout,
                        get_model(cfg, gen), device=dev)
    w_max = 8  # full-resolution slots
    cap = -(-w_max // world) * world
    rng = np.random.default_rng(seed)
    lo, hi = (0, cap) if mode == "dp" else distributed.host_shard(cap)
    # Every rank makes the whole store from the seed and keeps its slots.
    col = rng.integers(0, 255, (cap, cam.H, cam.W, 3), np.uint8)[lo:hi]
    dep = rng.integers(1000, 30000, (cap, cam.H, cam.W), np.uint16)[lo:hi]
    kf_c = (torch.as_tensor(col).to(dev).to(torch.float32)
            / 255.0).to(torch.float16)
    kf_d = torch.as_tensor(dep.astype(np.float32) / 6553.5).to(dev)
    del col, dep
    center = compute_bound(cfg).mean(axis=1)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (w_max, 1, 1))
    c2ws[:, :3, 3] = center
    poses = matrix_to_cam_pose(torch.as_tensor(c2ws).to(dev))
    pose_mask = torch.ones((w_max,), device=dev)
    pose_mask[0] = 0.0
    slot_kf = torch.arange(w_max, device=dev)
    iters = int(cfg["mapping"]["iters"])
    draws = TorchDraws(seed, dev)
    if mode == "dp":
        step = make_mapper(cfg, scene, cam, importance=False, sharded=True)
    elif mode == "kf":
        step = make_distributed_ba(cfg, scene, cam, iters=iters,
                                   pose_solver="adam")
    else:
        raise ValueError(f"unknown mode {mode!r}")
    chunk_s, losses = [], []
    for _ in range(frames):
        distributed.barrier()
        t0 = time.perf_counter()
        if mode == "dp":
            _, out = step(ms, poses, pose_mask, slot_kf, w_max, kf_c, kf_d,
                          draws, iters=iters, lr_factor=1.0)
        else:
            _, out = step(ms, poses, pose_mask, slot_kf, w_max,
                          (kf_c, kf_d, None), cap // world, draws)
        lv = out.cpu().numpy()  # a value read: the chunk has finished
        if not np.isfinite(lv).all():
            raise RuntimeError(f"bigstep[{mode}]: non-finite loss {lv}")
        chunk_s.append(time.perf_counter() - t0)
        losses.append(lv)
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    log(f"bigstep[{mode}] over {world} rank(s): first chunk "
        f"{chunk_s[0]:.2f} s, then {np.mean(chunk_s[1:] or chunk_s):.2f} "
        f"s per 15-iteration chunk, peak RSS {rss_mb:.0f} MB")
    return {"chunk_s": chunk_s, "rss_mb": rss_mb,
            "losses": np.concatenate(losses)}


def run_scaling_window(config: str | None = None, iters: int = 2,
                       seed: int = 0, device=None, log=print) -> dict:
    """``iters`` mapping iterations of one window on every rank of the
    gang (``make_mapper``, no importance branch), ray DP with the
    replicated Adam (``plain``) and then with the ``dp_impl: spmd`` draws
    and the row-sharded Adam (``zero``), from the same map: each one's
    collectives by kind (``distributed.COUNTS``).  The window is
    ``profile_components``': ``mapping_window_size`` keyframes of
    constant imagery, every pose at the bound's center, the oldest
    frozen.  ``config``: default ``configs/Synthetic/room.yaml``."""
    import torch

    from myslam_torch.core.quaternion import matrix_to_cam_pose
    from myslam_torch.core.sampling import TorchDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.engine.mapper import make_mapper
    from myslam_torch.models.config import get_model
    from myslam_torch.models.planes import init_map_state
    from myslam_torch.parallel import distributed
    from myslam_torch.render.renderer import scene_from_cfg
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    dev = distributed.rank_device(distributed.rank(), device)
    cfg = load_config(config or os.path.join(
        _REPO, "configs", "Synthetic", "room.yaml"), DEFAULT_CONFIG)
    cam = Camera.from_cfg(cfg)
    scene = scene_from_cfg(cfg)
    W = int(cfg["mapping"]["mapping_window_size"])
    c2ws = torch.eye(4, device=dev).repeat(W, 1, 1)
    c2ws[:, :3, 3] = scene.bound_tensor(dev).mean(dim=1)
    poses = matrix_to_cam_pose(c2ws)
    pose_mask = torch.ones((W,), device=dev)
    pose_mask[0] = 0.0
    kf_colors = torch.full((W, cam.H, cam.W, 3), 0.5, dtype=torch.float16,
                           device=dev)
    kf_depths = torch.full((W, cam.H, cam.W), 1.5, device=dev)
    out = {"world": distributed.world(), "backend": distributed.backend(),
           "iters": iters, "window": W}
    for name, spmd in (("plain", False), ("zero", True)):
        gen = torch.Generator().manual_seed(seed)
        ms = init_map_state(gen, scene.sdf_layout, scene.color_layout,
                            get_model(cfg, gen), device=dev)
        step = make_mapper(cfg, scene, cam, importance=False, sharded=True,
                           spmd=spmd, zero_opt=spmd)
        distributed.reset_counts()
        _, losses = step(ms, poses, pose_mask, torch.arange(W, device=dev),
                         W, kf_colors, kf_depths, TorchDraws(seed, dev),
                         iters=iters, lr_factor=1.0)
        if not torch.isfinite(losses).all():
            raise RuntimeError(f"scaling[{name}]: non-finite loss")
        out[name] = {k: dict(v) for k, v in distributed.COUNTS.items()}
    out["atlas_bytes"] = _atlas_bytes(ms)
    log(f"scaling window over {out['world']} rank(s): {out['plain']}, "
        f"{out['zero']}")
    return out


def run_system(config: str, seed: int = 0, device=None,
               frames: int | None = None, log=print) -> dict:
    """SLAMSystem's loop on a config file over the gang, then this rank's
    record: the trajectory, per-frame tracking and mapping ms, K1/K2
    launches, the collectives by kind (``distributed.COUNTS``) and the
    gradient all-reduces of each mapped frame, how far each mapped frame
    moved the keyframes already stored, the Schur system's K1/K2
    launches, the loop's peak device memory, the keyframe store's imagery
    bytes on this rank, and the device bytes above what it held that this
    rank takes for a checkpoint of the last frame, written after the
    loop; whether tracking is sharded and how it ran
    (``engine/tracker.GRAPH_COUNTS``) and how mapping ran
    (``engine/mapper.GRAPH_COUNTS``); the bytes of Adam's atlas moments on this rank in the last
    mapped frame (``engine/mapper.ADAM_BYTES``: the row-sharded Adam's);
    and for the host-staged store its host bytes, selection fetches,
    cache misses and bound lines, each line checked against its host
    slot (``KeyframeStore.check_cache``)."""
    import torch

    from myslam_torch.engine import mapper, tracker
    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.ops import cuda_sample
    from myslam_torch.parallel import distributed, distributed_ba
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
    from myslam_torch.utils.logger import save_checkpoint

    cfg = load_config(config, DEFAULT_CONFIG)
    if frames:
        cfg["data"]["n_frames"] = int(frames)
    slam = SLAMSystem(cfg, seed=seed,
                      device=distributed.rank_device(distributed.rank(),
                                                     device))
    if slam.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(slam.device)
    # Gradient reductions by the end of each mapped frame (the row-sharded
    # Adam's grad_rs in place of grad).
    grad_calls = []

    def mapped(system, idx):
        counts = distributed.COUNTS
        grad_calls.append(counts.get("grad_rs", counts.get("grad", {}))
                          .get("calls", 0))

    slam.on_map_done = mapped
    # Per mapped frame, the farthest that mapping moved a keyframe already
    # in the store (joint BA's pose write-back; 0 without joint frames).
    ba_moves = []
    map_frame = slam._map_frame

    def moved(idx, pkt, rec):
        n = slam.store.count
        before = slam.store.est_c2w[:n, :3, 3].clone()
        map_frame(idx, pkt, rec)
        ba_moves.append(float((slam.store.est_c2w[:n, :3, 3] - before)
                              .norm(dim=-1).max()) if n else 0.0)

    slam._map_frame = moved
    # The pipeline's snapshots (a digest of each, as the map role posts
    # them and as the track role takes them) and the map role's map after
    # each mapped frame.
    snaps = {"posted": [], "taken": [], "mapped": []}
    if slam.pipe is not None:
        import hashlib

        from myslam_torch.parallel.pipeline import pack_map

        def digest(flat):
            return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()

        link = slam.pipe
        post, take = link.post_snapshot, link.take_snapshot

        def posted(ms):
            post(ms)
            snaps["posted"].append(digest(link.last_snapshot))

        def taken(into):
            take(into)
            snaps["taken"].append(digest(pack_map(into)))

        link.post_snapshot, link.take_snapshot = posted, taken

        def mapped_digest(system, idx):
            mapped(system, idx)
            snaps["mapped"].append(digest(pack_map(system.map_state)))

        slam.on_map_done = mapped_digest
    cuda_sample.reset_launches()
    tracker.GRAPH_COUNTS.update(captures=0, replays=0, eager_iters=0)
    mapper.GRAPH_COUNTS.update(captures=0, replays=0, eager_iters=0)
    distributed.reset_counts()
    mapper.ADAM_BYTES.update(atlas_moments=0, atlas_moments_replicated=0)
    distributed.TRACE = []
    for k in distributed_ba.SCHUR_LAUNCHES:
        distributed_ba.SCHUR_LAUNCHES[k] = 0
    t0 = time.perf_counter()
    slam.run_loop()
    cuda = slam.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(slam.device)
    wall = time.perf_counter() - t0
    trace, distributed.TRACE = distributed.TRACE, None
    peak = torch.cuda.max_memory_allocated(slam.device) if cuda else None
    # One checkpoint of the last frame, and the device memory each rank
    # takes for it above what it held (a sharded store is gathered to
    # rank 0 alone).
    if cuda:
        held = torch.cuda.memory_allocated(slam.device)
        torch.cuda.reset_peak_memory_stats(slam.device)
    save_checkpoint(os.path.join(slam.output, "ckpts",
                                 f"{slam.n_img - 1:05d}.npz"), slam,
                    slam.n_img - 1)
    ckpt_bytes = (torch.cuda.max_memory_allocated(slam.device) - held
                  if cuda else None)
    log_recs = slam.frame_log
    st = slam.store
    host = None
    if st.host_mode:
        host = {"host_bytes": sum(t.numel() * t.element_size() for t in
                                  (st.colors_u8, st.depths_u16)),
                "selection_fetches": slam.selection_fetches,
                "cache_lines": st.cache_lines,
                "cache_misses": st.cache_misses,
                "bound_lines": st.check_cache()}
    out = {
        "rank": slam.rank, "world": slam.n_proc, "backend":
        distributed.backend(), "device": str(slam.device),
        "parallel": slam.parallel, "pose_solver": slam.pose_solver,
        "est": slam.estimates, "gt": slam.gt_poses,
        "ate_rmse_cm": slam.ate()["absolute_translational_error.rmse"]
        * 100.0,
        "wall_s": wall,
        "track_ms": [r["track_ms"] for r in log_recs if "track_ms" in r],
        "map_ms": [r["map_ms"] for r in log_recs if "map_ms" in r],
        "map_iters": [r["map_iters"] for r in log_recs if "map_iters" in r],
        "map_importance": [r["map_importance"] for r in log_recs
                           if "map_iters" in r],
        "map_frames": [r["frame"] for r in log_recs if "map_iters" in r],
        "grad_allreduces": np.diff([0] + grad_calls).tolist(),
        "ba_moves_m": ba_moves,
        "track_iters": int(cfg["tracking"]["iters"]),
        "tracked_frames": sum("track_ms" in r for r in log_recs),
        "launches": dict(cuda_sample.LAUNCHES),
        "schur_launches": dict(distributed_ba.SCHUR_LAUNCHES),
        "track_sharded": slam.track_sharded,
        "graph_counts": dict(tracker.GRAPH_COUNTS),
        "map_graph_counts": dict(mapper.GRAPH_COUNTS),
        "collectives": {k: dict(v) for k, v in distributed.COUNTS.items()},
        "store_mode": slam.store.mode,
        "store_capacity": slam.store.capacity,
        "store_local_capacity": slam.store.local_capacity,
        "store_imagery_bytes": slam.store.imagery_bytes(),
        "host_store": host,
        "plan": slam.plan,
        "adam_bytes": dict(mapper.ADAM_BYTES),
        "peak_mem_gb": peak / 1e9 if cuda else None,
        "ckpt_extra_mem_bytes": ckpt_bytes,
        "frame_start_s": (np.asarray(slam.frame_start_wall)
                          - slam.frame_start_wall[0]).tolist(),
        "drain_s": slam.drain_wall - slam.frame_start_wall[0],
        "snapshots": snaps,
        "pipeline_role": (None if slam.pipe is None else
                          "map" if slam.pipe.is_map else "track"),
        # The map this rank's mapping optimizes (map shards: its bands)
        # and the digest of the replicated map it ends with.
        "map_atlas_bytes": _atlas_bytes(getattr(slam, "_map_banded", None)
                                        or slam.map_state),
        "map_digest": _map_digest(slam.map_state),
        # The collectives' calls one by one: (kind, bytes, seconds).
        "trace": trace,
    }
    log(f"system rank {slam.rank}/{slam.n_proc}: {slam.n_img} frames, ATE "
        f"{out['ate_rmse_cm']:.3f} cm")
    return out


def _atlas_bytes(ms) -> int:
    """Bytes of a map's two atlases (Adam keeps two moments of each)."""
    return sum(t.numel() * t.element_size()
               for t in (ms.sdf_atlas, ms.color_atlas))


def _map_digest(ms) -> str:
    """sha256 of the map's atlases and decoder parameters, as bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in [ms.sdf_atlas, ms.color_atlas, *ms.decoder.parameters()]:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


def worker_main(argv=None) -> None:
    """One rank of a gang started by ``launch``."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--procid", type=int, required=True)
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--device", default=None,
                   help="cpu, or a CUDA device (default: the rank's GPU)")
    p.add_argument("--loop", default="mini",
                   choices=("mini", "product", "system", "validate",
                            "bigstep", "scaling", "pose_solver"))
    p.add_argument("--mode", default="dp",
                   choices=("dp", "kf", "kfdp", "map", "pipeline"))
    p.add_argument("--frames", type=int, default=None,
                   help="frames of the loop (default: the loop's own)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--replay", default=None)
    p.add_argument("--size", default="96x128")
    p.add_argument("--overrides", default="{}",
                   help="JSON merged into the mini-loop's config")
    args = p.parse_args(argv)

    import torch

    from myslam_torch.parallel import distributed

    # The ranks share this machine's cores.
    torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                     (os.cpu_count() or 1) // args.nproc)))
    distributed.init_distributed(args.coordinator, args.nproc, args.procid,
                                 args.device)
    dev = distributed.rank_device(args.procid, args.device)
    try:
        if args.loop == "mini":
            out = run_minislam(args.mode, args.frames or 6, args.seed, dev,
                               args.replay, json.loads(args.overrides))
        elif args.loop == "product":
            H, W = (int(v) for v in args.size.split("x"))
            out = run_product(args.mode, args.frames or 12, args.seed, dev,
                              (H, W))
        elif args.loop == "validate":
            out = run_validate(args.mode, args.frames or 4, args.seed, dev)
        elif args.loop == "bigstep":
            out = run_bigstep(args.mode, args.frames or 3, args.seed, dev)
        elif args.loop == "scaling":
            out = run_scaling_window(args.config, args.frames or 2,
                                     args.seed, dev)
        elif args.loop == "pose_solver":
            from myslam_torch.tools.bench_pose_solver import run_pose_solver

            out = run_pose_solver(json.loads(args.overrides), args.seed,
                                  dev)
        else:
            out = run_system(args.config, args.seed, dev, args.frames)
        with open(os.path.join(args.out, f"rank{args.procid}.json"),
                  "w") as f:
            json.dump(_jsonable(out), f)
    finally:
        distributed.shutdown()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def prebuild(device) -> None:
    """Build the kernels and the image codec once, before the ranks
    start, when the gang runs on GPUs (two ranks must not build into one
    folder at once)."""
    if device is None or str(device).split(":")[0] != "cpu":
        from myslam_torch.ops import cuda_sample
        from myslam_torch.utils import imageio

        cuda_sample.build()
        imageio.build()


def wait_gang(procs: list, timeout: float | None = None
              ) -> tuple[int, int | None]:
    """Poll the ranks until all have exited; on the first abnormal exit
    (or the timeout) kill the others.  Returns (exit code, the rank that
    failed or None); the timeout gives code 124."""
    t0 = time.time()
    live = list(range(len(procs)))
    while live:
        for r in list(live):
            rc = procs[r].poll()
            if rc is None:
                continue
            live.remove(r)
            if rc != 0:
                if live:
                    print(f"LAUNCH: rank {r} died (rc={rc}) - killing the "
                          f"remaining {len(live)} rank(s)", flush=True)
                for o in live:
                    procs[o].kill()
                for o in live:
                    procs[o].wait()
                return rc, r
        if timeout is not None and time.time() - t0 > timeout:
            print(f"LAUNCH: gang past its {timeout:.0f} s limit - killing "
                  "it", flush=True)
            for o in live:
                procs[o].kill()
            for o in live:
                procs[o].wait()
            return 124, live[0]
        time.sleep(0.1)
    return 0, None


def launch(nproc: int, mode: str = "dp", frames: int | None = None,
           seed: int = 0, timeout: float = 900.0, loop: str = "mini",
           device=None, config: str | None = None,
           replay: str | None = None, size=(96, 128),
           overrides: dict | None = None) -> list[dict]:
    """Run ``loop`` ("mini", "product", "system", "validate", "bigstep",
    "scaling" or "pose_solver") on a gang of ``nproc`` ranks; returns
    each rank's result in rank order.  ``frames`` None: the loop's own
    count (6, 12, the config's, 4, 3, 2 iterations; unused by
    "pose_solver", whose settings ride in ``overrides``).  Raises with
    the failing rank's output when a rank exits abnormally or the gang
    outlives ``timeout`` seconds."""
    prebuild(device)
    out_dir = tempfile.mkdtemp(prefix="gang_")
    coord = f"127.0.0.1:{free_port()}"
    procs, logs = [], []
    for r in range(nproc):
        cmd = [sys.executable, "-m", "myslam_torch.parallel.multiproc",
               "--procid", str(r), "--nproc", str(nproc),
               "--coordinator", coord, "--loop", loop, "--mode", mode,
               "--seed", str(seed), "--out", out_dir,
               "--size", f"{size[0]}x{size[1]}",
               "--overrides", json.dumps(overrides or {})]
        for flag, value in (("--device", device), ("--config", config),
                            ("--replay", replay), ("--frames", frames)):
            if value:
                cmd += [flag, str(value)]
        logs.append(open(os.path.join(out_dir, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            cmd, cwd=_REPO,
            stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        rc, bad = wait_gang(procs, timeout)
    finally:
        for f in logs:
            f.close()
    if rc != 0:
        with open(os.path.join(out_dir, f"rank{bad}.log")) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"gang rank {bad} rc={rc}:\n{tail}")
    results = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append({k: (np.asarray(v) if isinstance(v, list) else v)
                            for k, v in json.load(f).items()})
    return results


if __name__ == "__main__":
    worker_main()
