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
    launches, collectives, peak memory, keyframe bytes).

Every rank runs on its GPU (``distributed.rank_device``; it raises where
there is none) unless ``device="cpu"`` is given to ``launch`` and the
loops.  Every rank writes its result to ``<out>/rank<r>.json``;
``launch`` returns them in rank order.  ``run_validate`` and
``run_bigstep`` of the JAX module are not ported.
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


def product_cfg(frames: int = 12, mode: str = "dp", size=(96, 128)) -> dict:
    """SLAMSystem's config for the product loop over the gang (the JAX
    package's ``product_cfg``): the synthetic room at ``size`` (H, W),
    the chunked 15-iteration schedule with a 31-iteration first frame,
    the packed keyframe store, admission every 4th frame, joint BA once
    more than 4 keyframes, no panels, f32 quads; ``parallel.devices: 0``
    (dp) or ``kf_shards: 0`` (kf) over every rank."""
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
        "parallel": ({"devices": 0} if mode == "dp" else {"kf_shards": 0}),
    })
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
    from myslam_torch.utils.logger import save_checkpoint

    device = distributed.rank_device(distributed.rank(), device)
    cfg = product_cfg(frames, mode, size)
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
    save_checkpoint(os.path.join(out_dir, "ckpts",
                                 f"{slam.n_img - 1:05d}.npz"), slam,
                    slam.n_img - 1)
    slam2 = SLAMSystem(cfg, output=out_dir, seed=seed, device=device)
    start = slam2.resume()
    with torch.no_grad():
        est_err = float(np.abs(slam2.estimates - slam.estimates).max())
        map_err = float((slam2.map_state.sdf_atlas
                         - slam.map_state.sdf_atlas).abs().max())
        st = slam.store
        rows = (min(st.slot_offset + st.local_capacity, st.count)
                - min(st.slot_offset, st.count))
        store_err = max(
            [float((a[:rows].float() - b[:rows].float()).abs().max())
             for a, b in zip(slam2.store.imagery(), st.imagery())
             if a is not None and rows > 0] + [0.0])
    ok = (start == slam.n_img and slam2.store.count == slam.store.count
          and est_err == 0.0 and map_err == 0.0 and store_err == 0.0)
    out = {"est": slam.estimates, "map_losses": np.asarray(map_losses),
           "map_sum": float(slam.map_state.sdf_atlas.detach().abs().sum()),
           "resume_ok": float(ok), "resumed_from": start}
    log(f"product[{mode}] rank {slam.rank}/{slam.n_proc}: resumed at "
        f"{start}, ok {ok}")
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
    loop."""
    import torch

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
    grad_calls = []  # gradient all-reduces by the end of each mapped frame

    def mapped(system, idx):
        grad_calls.append(distributed.COUNTS.get("grad", {}).get("calls", 0))

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
    cuda_sample.reset_launches()
    distributed.reset_counts()
    for k in distributed_ba.SCHUR_LAUNCHES:
        distributed_ba.SCHUR_LAUNCHES[k] = 0
    t0 = time.perf_counter()
    slam.run_loop()
    cuda = slam.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(slam.device)
    wall = time.perf_counter() - t0
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
        "collectives": {k: dict(v) for k, v in distributed.COUNTS.items()},
        "store_mode": slam.store.mode,
        "store_capacity": slam.store.capacity,
        "store_local_capacity": slam.store.local_capacity,
        "store_imagery_bytes": slam.store.imagery_bytes(),
        "peak_mem_gb": peak / 1e9 if cuda else None,
        "ckpt_extra_mem_bytes": ckpt_bytes,
    }
    log(f"system rank {slam.rank}/{slam.n_proc}: {slam.n_img} frames, ATE "
        f"{out['ate_rmse_cm']:.3f} cm")
    return out


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
                   choices=("mini", "product", "system"))
    p.add_argument("--mode", default="dp", choices=("dp", "kf"))
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
    """Run ``loop`` ("mini", "product" or "system") on a gang of
    ``nproc`` ranks; returns each rank's result in rank order.
    ``frames`` None: the loop's own count (6, 12, the config's).  Raises
    with the failing rank's output when a rank exits abnormally or the
    gang outlives ``timeout`` seconds."""
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
