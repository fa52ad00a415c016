#!/usr/bin/env python
"""Keyframe-sharded BA's pose solvers at equal wall time.

    python -m myslam_torch.tools.bench_pose_solver [--budget-s 10]
        [--chunk 8] [--shards 4] [--train-iters 60] [--seed 0]
        [--device cpu] [--json FILE]

The counterpart of ``myslam_tpu/tools/bench_pose_solver.py``: the Schur
pose step costs more than an Adam iteration, so iterations alone cannot
rank the solvers; this gives each the same seconds on the same
perturbed-pose scenario and reports the pose error against wall time.

Scenario (the JAX tool's): the synthetic room at 48x64, 512 rays, planes
at 0.48 / 0.12 m of 8 channels, 12 + 4 samples with jitter; keyframes of
frames 0, 5, 10 and 15, sharded over the ``--shards`` ranks
(``parallel/distributed_ba.make_distributed_ba``); the map trained for
three rounds of ``--train-iters`` (60) Adam iterations at the true
poses; then slot 2's pose perturbed (``default_rng(1)``: translation
~2.5 cm, quaternion ~1.2e-2).
Each solver (``adam``, ``schur``, ``schur@4``: the reduced solve every
4th iteration, ``schur_interval``) starts from that map and pose, is
warmed up by one chunk on a copy, then runs chunks of ``--chunk`` BA
iterations until its ``--budget-s`` seconds are spent (rank 0's clock
decides for every rank); slot 2's translation error is sampled after
every chunk.  ``--shards`` 1 runs in this process; more start a gang
(``multiproc.launch``), whose ranks run on their GPUs unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

SOLVERS = ("adam", "schur", "schur@4")
FRAMES = (0, 5, 10, 15)
PERTURBED = 2


def run_pose_solver(settings: dict, seed: int = 0, device=None,
                    log=print) -> dict:
    """The comparison on this rank of the current process group (every
    rank returns the same record).  ``settings``: ``budget_s``, ``chunk``
    and ``train_iters``."""
    import copy
    import os

    import numpy as np
    import torch

    from myslam_torch.core.quaternion import cam_pose_to_matrix, \
        matrix_to_cam_pose
    from myslam_torch.core.sampling import TorchDraws
    from myslam_torch.engine.camera import Camera
    from myslam_torch.models.config import get_model
    from myslam_torch.models.planes import compute_bound, init_map_state, \
        make_layout
    from myslam_torch.parallel import distributed
    from myslam_torch.parallel.distributed_ba import make_distributed_ba
    from myslam_torch.parallel.pipeline import copy_map
    from myslam_torch.render.renderer import SceneGeometry
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
    from myslam_torch.utils.datasets import get_dataset

    budget_s, chunk = float(settings["budget_s"]), int(settings["chunk"])
    train_iters = int(settings["train_iters"])
    dev = distributed.rank_device(distributed.rank(), device)
    world = distributed.world()
    if len(FRAMES) % world:
        raise ValueError(f"{len(FRAMES)} keyframes do not split over "
                         f"{world} shards")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = copy.deepcopy(load_config(
        os.path.join(repo, "configs", "Synthetic", "room_smoke.yaml"),
        DEFAULT_CONFIG))
    cfg["cam"].update(H=48, W=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5)
    cfg["data"]["n_frames"] = 16
    cfg["mapping"]["pixels"] = 512
    dataset = get_dataset(cfg)
    cam = Camera.from_cfg(cfg)
    bound = compute_bound(cfg)
    layout_s = make_layout(bound, [0.48, 0.12], 8)
    layout_c = make_layout(bound, [0.48, 0.12], 8)
    scene = SceneGeometry(layout_s, layout_c,
                          tuple(map(tuple, bound.tolist())), 0.06, 12, 4,
                          True)
    gen = torch.Generator().manual_seed(seed)
    ms = init_map_state(gen, layout_s, layout_c,
                        get_model({"model": {"c_dim": 8}}, gen), device=dev)

    frames = [dataset.get_frame(i) for i in FRAMES]
    lo, hi = distributed.host_shard(len(FRAMES))
    imagery = (torch.as_tensor(np.stack([f[0] for f in frames[lo:hi]]),
                               dtype=torch.float16).to(dev),
               torch.as_tensor(np.stack([f[1] for f in frames[lo:hi]])
                               ).to(dev), None)
    local = hi - lo
    poses_true = matrix_to_cam_pose(torch.as_tensor(
        np.stack([f[2] for f in frames])).to(dev))
    slot_kf = torch.arange(len(FRAMES), device=dev)
    n_slots = len(FRAMES)

    # The map trained at the true poses (every solver starts from it).
    train = make_distributed_ba(cfg, scene, cam, iters=train_iters,
                                pose_solver="adam")
    frozen = torch.zeros((len(FRAMES),), device=dev)
    for r in range(3):
        train(ms, poses_true, frozen, slot_kf, n_slots, imagery, local,
              TorchDraws(seed + 100 + r, dev))
    rng = np.random.default_rng(1)
    poses_pert = poses_true.cpu().numpy().copy()
    poses_pert[PERTURBED, 4:] += rng.normal(scale=0.025, size=3)
    poses_pert[PERTURBED, :4] += rng.normal(scale=0.012, size=4)
    poses_pert = torch.as_tensor(poses_pert).to(dev)
    mask = torch.zeros((len(FRAMES),), device=dev)
    mask[PERTURBED] = 1.0
    c_true = cam_pose_to_matrix(poses_true)[PERTURBED, :3, 3]

    def t_err(p7):
        c = cam_pose_to_matrix(p7)[PERTURBED, :3, 3]
        return float(torch.linalg.norm(c - c_true))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {"budget_s": budget_s, "chunk": chunk, "shards": world,
           "device": str(dev), "err_initial_m": t_err(poses_pert),
           "solvers": {}}
    for solver in SOLVERS:
        name, _, every = solver.partition("@")
        ba = make_distributed_ba(cfg, scene, cam, iters=chunk,
                                 pose_solver=name,
                                 schur_interval=int(every or 1))
        # Warm-up on a copy (not billed).
        ba(copy_map(ms), poses_pert, mask, slot_kf, n_slots, imagery, local,
           TorchDraws(seed + 7, dev))
        sync()
        state, poses = copy_map(ms), poses_pert
        trace, iters_done = [], 0
        distributed.barrier()
        t0 = time.perf_counter()
        while distributed.broadcast_object(
                time.perf_counter() - t0 < budget_s):
            poses, losses = ba(state, poses, mask, slot_kf, n_slots,
                               imagery, local,
                               TorchDraws(seed + 7 + iters_done, dev))
            err = t_err(poses)  # a value fetch: the chunk is done
            iters_done += chunk
            trace.append({"wall_s": time.perf_counter() - t0,
                          "iters": iters_done, "err_m": err,
                          "loss": float(losses[-1])})
        wall = time.perf_counter() - t0
        out["solvers"][solver] = {
            "iters_done": iters_done, "wall_s": wall,
            "ms_per_iter": wall / max(iters_done, 1) * 1e3,
            "err_final_m": trace[-1]["err_m"] if trace else None,
            "trace": trace}
        log(f"{solver}: {iters_done} iters in {wall:.1f} s -> err "
            f"{out['solvers'][solver]['err_final_m']} m (from "
            f"{out['err_initial_m']:.4f})")
    errs = {k: v["err_final_m"] for k, v in out["solvers"].items()
            if v["err_final_m"] is not None}
    out["winner_at_equal_wall"] = min(errs, key=errs.get) if errs else None
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget-s", type=float, default=10.0,
                    help="wall seconds granted to each solver")
    ap.add_argument("--chunk", type=int, default=8,
                    help="BA iterations per chunk")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--train-iters", type=int, default=60,
                    help="Adam iterations of each of the map's three "
                         "training rounds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (each rank's); 'cpu'")
    ap.add_argument("--json", default=None, help="write the report here")
    args = ap.parse_args(argv)
    settings = {"budget_s": args.budget_s, "chunk": args.chunk,
                "train_iters": args.train_iters}
    if args.shards == 1:
        out = run_pose_solver(settings, args.seed, args.device)
    else:
        from myslam_torch.parallel import multiproc

        out = multiproc.launch(
            args.shards, loop="pose_solver", seed=args.seed,
            device=args.device, overrides=settings,
            timeout=600 + 6 * args.budget_s)[0]
    print("winner at equal wall:", out["winner_at_equal_wall"])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
