"""SLAM orchestration: the tracking/mapping interleave on one device.

The serialized order of the reference's two processes, per every_frame
group E:

    map(0) | track(1..E) map(E) | track(E+1..2E) map(2E) | ... map(last)

Between two mapped frames the map is frozen, so the tracked frames of a
group are buffered and tracked together at the next mapped frame
(``make_group_tracker`` packs the quads once per group); the results are
those of tracking each frame as it arrives.

This is the single-device, non-pipelined mode of
``myslam_tpu.engine.scheduler.SLAMSystem``, with its keyframe store
modes (``keyframe_device``: the float, packed and host-staged stores),
its loop timing (``frame_start_wall``, ``frame_times``, ``drain_wall``,
``sync_after_frame``) and its bookkeeping: ``<output>/metrics.jsonl``,
the periodic checkpoints and meshes (``mapping.ckpt_freq`` /
``mesh_freq``), the final ones, the heartbeat that ``run_torch.py
--supervise`` watches and the fault hook, and ``resume``; and the
in-loop panels (``tracking/mapping.vis_freq``, ``vis_inside_freq``,
``utils/visualizer.py``).  On a CUDA device the prefetch thread stages
each packet's uploads (``datasets.stage_packet``).

The config's ``parallel`` section is read by the JAX package's rules
(``parallel_mode``): one rank is one process and one device, and every
rank of the process group (``parallel/distributed.py``) runs this same
loop.  ``parallel.devices`` is ray data parallelism (the mapper's ray
batch split over the ranks, one gradient all-reduce per iteration),
``parallel.kf_shards`` keyframe-sharded BA (each rank holds its own
keyframe slots' imagery; ``pose_solver`` adam or schur); under either,
tracking splits its pixel batch over the ranks.  Rank 0 alone writes
metrics.jsonl, the checkpoints, the meshes and the heartbeat; the
panels are off; resume is decided by rank 0 and broadcast.  Everything
else of the JAX package's ``parallel`` section raises.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from myslam_torch import resolve_device
from myslam_torch.core.quaternion import cam_pose_to_matrix
from myslam_torch.core.sampling import TorchDraws
from myslam_torch.engine.camera import Camera
from myslam_torch.engine.keyframes import KeyframeStore, \
    make_window_selector, store_mode
from myslam_torch.engine.mapper import make_frame_mapper, \
    make_window_frame_mapper
from myslam_torch.engine.tracker import make_group_tracker
from myslam_torch.models.config import get_model
from myslam_torch.models.planes import compute_bound, init_map_state
from myslam_torch.ops import cuda_sample
from myslam_torch.parallel import distributed
from myslam_torch.render.renderer import scene_from_cfg
from myslam_torch.tools.cull_mesh import cull_mesh
from myslam_torch.tools.eval_ate import evaluate_run
from myslam_torch.utils import imageio
from myslam_torch.utils.datasets import PacketPrefetcher, Prefetcher, \
    build_packet, get_dataset, wait_staged
from myslam_torch.utils.logger import latest_checkpoint, load_checkpoint, \
    save_checkpoint
from myslam_torch.utils.mesher import Mesher
from myslam_torch.utils.visualizer import FrameVisualizer

# The panels' draw source is seeded with the run's seed plus this, so
# that rendering a panel takes no number from the loop's draws.
VIS_SEED_OFFSET = 7919
# A panel frequency no frame reaches (panels off).
NEVER = 10 ** 9


def parallel_mode(cfg: dict, world: int) -> str | None:
    """The parallel mode of ``cfg["parallel"]`` in a process group of
    ``world`` ranks: None, "dp" for ray data parallelism (``devices``)
    or "kf" for keyframe-sharded BA (``kf_shards``); 0 means every
    rank.  Raises ValueError, naming the mode, for what the port does
    not run (``pipeline``, ``map_shards``, kf_shards x devices,
    ``dp_impl: spmd``) and for a mode whose rank count is not the
    process group's: one rank is one process and one device, so
    ``devices: 2`` needs a group of 2."""
    par = cfg.get("parallel", {}) or {}

    def n(name):
        v = int(par.get(name, 1))
        return world if v == 0 else v

    n_dev, map_shards, kf_shards = n("devices"), n("map_shards"), \
        n("kf_shards")
    if bool(par.get("pipeline", False)):
        raise ValueError("parallel.pipeline (the track||map pipeline) is "
                         "not ported to myslam_torch")
    if map_shards > 1:
        raise ValueError("parallel.map_shards (banded map shards) is not "
                         "ported to myslam_torch")
    if n_dev > 1 and kf_shards > 1:
        raise ValueError("parallel.kf_shards x parallel.devices (composed "
                         "kf x dp) is not ported to myslam_torch")
    dp_impl = str(par.get("dp_impl", "shardmap")).lower()
    if dp_impl != "shardmap":
        raise ValueError(f"parallel.dp_impl: {dp_impl} is not ported to "
                         "myslam_torch (its ray DP is the shardmap one: one "
                         "gradient all-reduce per iteration)")
    mode, ranks = ((("dp", n_dev) if n_dev > 1 else ("kf", kf_shards))
                   if max(n_dev, kf_shards) > 1 else (None, 1))
    if ranks != world:
        what = ("parallel.devices" if mode == "dp" else
                "parallel.kf_shards" if mode == "kf" else
                "a single-device config")
        raise ValueError(
            f"{what} ({mode or 'no parallel mode'}, {ranks} rank(s)) needs "
            f"a process group of {ranks} rank(s), one process and one "
            f"device each; this process group has {world} (run_torch.py "
            "--launch N starts one)")
    return mode


class SLAMSystem:
    """Owns the scene state and drives the tracking/mapping loop.

    Every random draw of tracking and mapping comes from one
    ``TorchDraws`` seeded with ``seed``.  ``frame_log`` collects one
    record per frame: host and device milliseconds of its tracking (per
    frame of its group) and mapping, the losses, and the frame's wall
    time; each record is also a line of ``<output>/metrics.jsonl``.
    Checkpoints go to ``<output>/ckpts`` (``output`` defaults to
    ``data.output``), meshes and their culled copies to
    ``<output>/mesh``.  ``input_folder`` overrides ``data.input_folder``
    for the datasets read from disk.
    """

    def __init__(self, cfg: dict, input_folder: str | None = None,
                 output: str | None = None, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output = output or cfg["data"]["output"]
        os.makedirs(os.path.join(self.output, "ckpts"), exist_ok=True)
        os.makedirs(os.path.join(self.output, "mesh"), exist_ok=True)
        self.verbose = bool(cfg.get("verbose", False))
        self.seed = int(seed)
        self.cam = Camera.from_cfg(cfg)
        self.bound = compute_bound(cfg)
        self.scene = scene_from_cfg(cfg)
        self.sdf_layout = self.scene.sdf_layout
        self.color_layout = self.scene.color_layout

        # The initial map comes from a CPU generator, so a seed gives the
        # same map on every device.
        gen = torch.Generator().manual_seed(self.seed)
        self.map_state = init_map_state(
            gen, self.sdf_layout, self.color_layout, get_model(cfg, gen),
            device=self.device)
        self.draws = TorchDraws(self.seed, self.device)
        self.mesher = Mesher(cfg, self.scene, self.cam)
        self.eval_rec = bool(cfg["meshing"].get("eval_rec", False))
        # The culled final mesh, once finalize has written it, and the
        # seconds of the last finalize's steps (checkpoint, mesh, cull).
        self.final_mesh: str | None = None
        self.finalize_seconds: dict = {}

        self.dataset = get_dataset(cfg, input_folder)
        self.n_img = len(self.dataset)
        self.n_proc = distributed.world()
        self.rank = distributed.rank()
        self.proc0 = self.rank == 0
        self.parallel = parallel_mode(cfg, self.n_proc)
        self.pose_solver = str((cfg.get("parallel", {}) or {}).get(
            "pose_solver", "adam"))
        m = cfg["mapping"]
        self.ckpt_freq = int(m["ckpt_freq"])
        self.mesh_freq = int(m["mesh_freq"])
        self.no_log_on_first_frame = bool(
            m.get("no_log_on_first_frame", True))
        self.no_mesh_on_first_frame = bool(
            m.get("no_mesh_on_first_frame", True))
        self.every_frame = int(m["every_frame"])
        self.keyframe_every = int(m["keyframe_every"])
        self.window_size = int(m["mapping_window_size"])
        self.joint_opt_enabled = bool(m["joint_opt"])
        self.gt_camera = bool(cfg["tracking"].get("gt_camera", False))
        # In-loop panels (JAX's gating, myslam_tpu/engine/scheduler.py):
        # tracking panels of every tracking.vis_freq-th frame, mapping
        # panels of every mapping.vis_freq-th mapped frame but frame 0
        # under no_vis_on_first_frame.
        self.no_vis_on_first_frame = bool(m.get("no_vis_on_first_frame",
                                                True))
        t = cfg["tracking"]
        self.vis_draws = TorchDraws(self.seed + VIS_SEED_OFFSET, self.device)
        # Panels are per-rank debug output: off in a multi-rank run.
        self.track_vis = FrameVisualizer(
            t["vis_freq"] if self.n_proc == 1 else NEVER,
            t["vis_inside_freq"],
            os.path.join(self.output, "tracking_vis"), self.scene, self.cam,
            self.vis_draws, self.verbose)
        self.map_vis = FrameVisualizer(
            m["vis_freq"] if self.n_proc == 1 else NEVER,
            m["vis_inside_freq"],
            os.path.join(self.output, "mapping_vis"), self.scene, self.cam,
            self.vis_draws, self.verbose)

        mapped = sorted(set(list(range(0, self.n_img, self.every_frame))
                            + [self.n_img - 1]))
        n_keyframes = sum(1 for i in mapped if i % self.keyframe_every == 0)
        # Keyframes, plus one spare, plus the scratch slot (the last),
        # padded as the JAX package pads it: to the smallest multiple
        # that makes the flattened imagery whole 128-lane rows (1 at
        # 680x1200 and 480x640, 8 at ScanNet's 460x620 crop).  The window
        # selector draws over the capacity, so the pad keeps its draws.
        row_pad = 128 // math.gcd(self.cam.H * self.cam.W, 128)
        if self.parallel == "kf":
            # The slots split evenly over the ranks, as the JAX package
            # pads its capacity to the kf mesh.
            row_pad = row_pad * self.n_proc // math.gcd(row_pad,
                                                        self.n_proc)
        capacity = -(-(n_keyframes + 2) // row_pad) * row_pad
        # keyframe_device picks the store: the float store, the packed
        # wire format on the device (``cpu``/``packed``), or host imagery
        # behind a device line cache (``host``/``host_staged``).
        self.keyframe_device = str(
            cfg.get("keyframe_device", "device")).lower()
        mode = store_mode(self.keyframe_device)
        if mode == "host_staged" and self.n_proc > 1:
            raise ValueError(
                "keyframe_device: host_staged is single-process; use "
                "'packed' (what 'cpu' maps to) with parallel.devices or "
                "parallel.kf_shards")
        self.store = KeyframeStore(
            capacity, self.cam, self.device, mode=mode,
            shard=((self.rank, self.n_proc) if self.parallel == "kf"
                   else None))
        self.scratch_slot = self.store.capacity - 1
        self.w_max = self.window_size + 2  # picks + last two + current
        if self.store.host_mode:
            # The window and the scratch line must fit; more lines mean
            # fewer re-uploads after eviction.
            self.store.init_cache(max(
                self.w_max + 1, min(int(m.get("host_cache_lines", 64)),
                                    self.store.capacity + 1)))
        # Host reads of the selected window (host-staged store only).
        self.selection_fetches = 0

        # Tracking splits its pixel batch over the ranks under ray DP
        # and runs replicated under kf_shards, as the JAX package hands
        # the tracker its ray sharding: every rank draws the same pixels
        # from the same stream and makes the same pose, with no
        # collective.
        self.group_tracker = make_group_tracker(
            cfg, self.scene, self.cam, sharded=self.parallel == "dp")
        self._selector = make_window_selector(
            self.cam, self.store.capacity, self.window_size, self.w_max,
            self.scratch_slot,
            method=m.get("keyframe_selection_method", "overlap"))
        # The depth-less sampling branch is built only when some frame in
        # the store has depth holes (see _map_frame).
        if self.store.host_mode:
            self._mappers = {
                imp: make_window_frame_mapper(cfg, self.scene, self.cam,
                                              self.w_max, importance=imp)
                for imp in (False, True)}
        elif self.parallel == "kf":
            from myslam_torch.parallel.distributed_ba import \
                make_kf_frame_mapper
            self._mappers = {
                imp: make_kf_frame_mapper(
                    cfg, self.scene, self.cam, self._selector, self.w_max,
                    self.scratch_slot, importance=imp,
                    pose_solver=self.pose_solver, packed=self.store.packed)
                for imp in (False, True)}
        else:
            self._mappers = {
                imp: make_frame_mapper(cfg, self.scene, self.cam,
                                       self._selector, self.w_max,
                                       self.scratch_slot, importance=imp,
                                       packed=self.store.packed,
                                       sharded=self.parallel == "dp")
                for imp in (False, True)}
        self._iters_first = int(m["iters_first"])
        self._iters = int(m["iters"])
        self._lr_first_factor = float(m["lr_first_factor"])
        self._lr_factor = float(m["lr_factor"])

        self.est = torch.zeros((self.n_img, 4, 4), dtype=torch.float32,
                               device=self.device)
        self.gt_poses = np.zeros((self.n_img, 4, 4), np.float32)
        self._track_buf: list = []
        self.frame_log: list[dict] = []
        # Optional hook, called as f(self, idx) after each mapped frame.
        self.on_map_done = None
        # Loop timing (perf_counter seconds): each frame's start, each
        # frame's host time, and the end of the drain after the loop.
        # Work is queued asynchronously, so throughput is measured from a
        # frame's start to the drain, not from the per-frame times.
        self.frame_start_wall: list[float] = []
        self.frame_times: list[float] = []
        self.drain_wall = 0.0
        # Benchmarking: drain the device after this frame, so a window
        # starting at the next frame holds no backlog of frame 0's work.
        self.sync_after_frame: int | None = None
        self._build_seconds_at_start = self._build_seconds()
        # metrics.jsonl: records wait here, device scalars and all, and
        # are read back in one batch at a flush (every 200 records,
        # before each periodic checkpoint, after the drain).
        self.metrics_path = os.path.join(self.output, "metrics.jsonl")
        self.metrics_flush_every = 200
        self._pending_metrics: list[dict] = []
        self._compile_logged = 0.0
        # Seconds of each periodic checkpoint and mesh, by frame.
        self.bookkeeping: list[dict] = []

    # -- helpers -------------------------------------------------------------

    def _to_dev(self, a, dtype: torch.dtype | None = None) -> torch.Tensor:
        """A host array or tensor on the device (a no-op for a tensor
        already there, such as a staged packet's), cast to ``dtype``."""
        t = torch.as_tensor(a).to(self.device)
        return t if dtype is None else t.to(dtype)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, fn):
        """Run fn(); returns (result, host ms to return, ms to the device
        finishing its work)."""
        self._sync()
        t0 = time.perf_counter()
        out = fn()
        t_host = time.perf_counter()
        self._sync()
        t_dev = time.perf_counter()
        return out, (t_host - t0) * 1e3, (t_dev - t0) * 1e3

    def _needs_full(self, idx: int) -> bool:
        """Frames whose full imagery the packet carries: mapped frames
        (keyframe store, mapping rays) and the panels' frames."""
        return (idx % self.every_frame == 0 or idx == self.n_img - 1
                or idx % self.track_vis.freq == 0
                or idx % self.map_vis.freq == 0)

    def _make_packet(self, dataset, idx: int):
        t = self.cfg["tracking"]
        return build_packet(
            dataset, idx, iters=int(t["iters"]), n_px=int(t["pixels"]),
            ie_h=int(t["ignore_edge_H"]), ie_w=int(t["ignore_edge_W"]),
            need_full=self._needs_full(idx), seed=self.seed)

    # -- panels ----------------------------------------------------------------

    @staticmethod
    def _gt_frame(pkt) -> tuple:
        """A full packet's input depth (H, W) and color (H, W, 3) in
        [0, 1], float32 on the host, as the store dequantizes them."""
        color_u8, depth_u16 = pkt.imagery_host()
        return (depth_u16.astype(np.float32) * np.float32(pkt.depth_inv_q),
                color_u8.astype(np.float32) / np.float32(255.0))

    def _maybe_track_vis(self, idx: int, pkt, iter_poses) -> None:
        """Tracking panels of frame idx at iterations 0, inside_freq, ...
        at each iteration's pre-update pose (``iter_poses`` (iters, 7)):
        the map is frozen while a group is tracked, so panel k rendered
        after the group is the one of iteration k."""
        if idx % self.track_vis.freq != 0 or pkt.color_u8 is None:
            return
        gt_depth, gt_color = self._gt_frame(pkt)
        c2ws = cam_pose_to_matrix(iter_poses)
        for it in range(0, iter_poses.shape[0], self.track_vis.inside_freq):
            self.track_vis.save_imgs(idx, it, gt_depth, gt_color, c2ws[it],
                                     self.map_state)

    def _make_map_vis_hook(self, idx: int, pkt):
        """Mapping panels of frame idx: iteration 0's now, against the map
        before mapping at the tracked pose; then the mapper's hook, called
        at every multiple m of inside_freq below the iteration count with
        the map after m iterations.  None when idx has no panels."""
        if (idx % self.map_vis.freq != 0
                or (idx == 0 and self.no_vis_on_first_frame)
                or pkt.color_u8 is None):
            return None
        gt_depth, gt_color = self._gt_frame(pkt)
        self.map_vis.save_imgs(idx, 0, gt_depth, gt_color, self.est[idx],
                               self.map_state)

        def hook(m, ms, c2w):
            self.map_vis.save_imgs(idx, m, gt_depth, gt_color, c2w, ms)

        return hook

    # -- tracking and mapping --------------------------------------------------

    def _flush_track_buf(self, open_rec: dict | None = None) -> None:
        """Track the buffered frames of one group against the frozen map,
        then log their records, except ``open_rec``: the current frame's,
        which its own iteration finishes and logs."""
        buf, self._track_buf = self._track_buf, []
        if not buf:
            return
        idx0 = buf[0][0]

        def stack(name, dtype=None):
            return torch.stack([self._to_dev(getattr(p, name), dtype)
                                for _, p, _ in buf])

        def run():
            return self.group_tracker(
                self.map_state, self.est, idx0,
                stack("px_i", torch.int64), stack("px_j", torch.int64),
                stack("px_color"), stack("px_depth"), self.draws)

        (_, loss_first, loss_best, iter_poses), host_ms, ms = self._timed(
            run)
        for g, (idx, pkt, rec) in enumerate(buf):
            rec["track_host_ms"] = host_ms / len(buf)
            rec["track_ms"] = ms / len(buf)
            rec["track_loss_first"] = loss_first[g]
            rec["track_loss_best"] = loss_best[g]
            self._maybe_track_vis(idx, pkt, iter_poses[g])
            if rec is not open_rec:
                self._log_metrics(rec)

    def _map_frame(self, idx: int, pkt, rec: dict) -> None:
        first = idx == 0
        joint_opt = self.joint_opt_enabled and self.store.count > 4
        admit = idx % self.keyframe_every == 0
        needs_importance = pkt.has_depthless or any(
            self.store.has_depthless[:self.store.count])
        mapper = self._mappers[needs_importance]
        iters = self._iters_first if first else self._iters
        lr_factor = self._lr_first_factor if first else self._lr_factor

        def run():
            # The mapping panels fall within the frame's map_ms.
            vis = {"vis_hook": self._make_map_vis_hook(idx, pkt),
                   "vis_every": self.map_vis.inside_freq}
            if self.store.host_mode:
                return self._map_frame_host(mapper, idx, pkt, iters,
                                            lr_factor, joint_opt, admit,
                                            vis)
            return mapper(
                self.map_state, self.store, self.est,
                self._to_dev(pkt.color_u8), self._to_dev(pkt.depth_u16),
                pkt.depth_inv_q, self._to_dev(pkt.gt_c2w), idx, self.draws,
                iters=iters, lr_factor=lr_factor, joint_opt=joint_opt,
                admit=admit, **vis)

        losses, host_ms, ms = self._timed(run)
        if admit and not self.store.host_mode:
            self.store.note_admitted(pkt.has_depthless, idx)
        rec["map_host_ms"] = host_ms
        rec["map_ms"] = ms
        rec["map_iters"] = int(losses.shape[0])
        rec["map_importance"] = bool(needs_importance)
        rec["map_loss_first"] = losses[0]
        rec["map_loss_last"] = losses[-1]
        rec["map_loss"] = losses[-1]

    def _select_host(self, idx: int, joint_opt: bool):
        """Window selection as its own step, for the host-staged store:
        the fused mapper's draws in the same order, on the current depth
        dequantized from the scratch line as the packed store does it.
        The window's slots and its size come back to the host in one
        fetch.  Returns (slot_kf, n_slots, pose_mask) on the device and
        (slot_kf, n_slots) on the host."""
        st = self.store
        cur_depth = (st.cache_depths[st.scratch_line].to(torch.float32)
                     * st.cache_inv_q[st.scratch_line])
        slot_kf, n_slots, pose_mask = self._selector(
            st.est_c2w, st.count, self.est[idx], cur_depth, self.draws,
            joint_opt)
        host = torch.cat([slot_kf, n_slots[None]]).cpu().numpy()
        self.selection_fetches += 1
        return (slot_kf, n_slots, pose_mask), (host[:-1], int(host[-1]))

    def _map_frame_host(self, mapper, idx: int, pkt, iters: int,
                        lr_factor: float, joint_opt: bool, admit: bool,
                        vis: dict):
        """A mapped frame over the host-staged store: the packet into the
        scratch line, selection, the window's missing slots uploaded into
        the line cache, the iterations over the cache slab, then the
        imagery admitted on the host and bound to a line."""
        st = self.store
        scratch_line = st.stage_scratch(pkt.color_u8, pkt.depth_u16,
                                        pkt.depth_inv_q)
        (slot_kf, n_slots, pose_mask), (host_slots, n_host) = \
            self._select_host(idx, joint_opt)
        win_lines = np.full((self.w_max,), scratch_line, np.int64)
        if n_host > 1:
            win_lines[:n_host - 1] = st.stage_lines(host_slots[:n_host - 1])
        losses = mapper(
            self.map_state, st, self.est, slot_kf, n_slots, pose_mask,
            self._to_dev(win_lines), self._to_dev(pkt.gt_c2w), idx,
            self.draws, iters=iters, lr_factor=lr_factor,
            joint_opt=joint_opt, admit=admit, **vis)
        if admit:
            # The host store takes the packet's numpy imagery: a staged
            # packet's device copy is not read back.
            color_u8, depth_u16 = pkt.imagery_host()
            pos = st.add_host(idx, color_u8, depth_u16, pkt.depth_inv_q,
                              pkt.has_depthless)
            st.bind_scratch(pos)
        return losses

    # -- bookkeeping -----------------------------------------------------------

    def _log_metrics(self, record: dict) -> None:
        """Queue a record for metrics.jsonl; its device scalars are read
        at the next flush."""
        self._pending_metrics.append(record)
        if len(self._pending_metrics) >= self.metrics_flush_every:
            self._flush_metrics()

    def _flush_metrics(self) -> None:
        """Append the queued records to metrics.jsonl, their device
        scalars read back in one copy; first a ``build`` record when this
        system has compiled the kernels or the codec since the last
        one."""
        lines = []
        built = self.compile_secs - self._compile_logged
        if built > 0:
            lines.append({"phase": "build", "compile_secs": built})
            self._compile_logged += built
        pending, self._pending_metrics = self._pending_metrics, []
        keys = [(rec, k) for rec in pending for k, v in rec.items()
                if isinstance(v, torch.Tensor)]
        if keys:
            values = torch.stack([rec[k].detach().reshape(()).float()
                                  for rec, k in keys]).cpu().tolist()
            for (rec, k), v in zip(keys, values):
                rec[k] = v
        lines += pending
        if lines and self.proc0:
            with open(self.metrics_path, "a") as f:
                f.writelines(json.dumps(r) + "\n" for r in lines)

    def _reset_metrics(self, start_idx: int) -> None:
        """Keep of metrics.jsonl only the frames before ``start_idx`` (a
        resumed run logs the rest again; a fresh one starts empty), so
        that after a restart every frame is in the file once.  Rank 0's
        file."""
        if not self.proc0:
            return
        kept = []
        if start_idx > 0 and os.path.exists(self.metrics_path):
            with open(self.metrics_path) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec.get("frame", -1) < start_idx:
                        kept.append(line)
        with open(self.metrics_path, "w") as f:
            f.writelines(kept)

    def _post_map(self, idx: int) -> None:
        """The periodic checkpoint and mesh after mapped frame ``idx``, at
        the JAX package's cadence (``SLAMSystem._post_map``): a checkpoint
        every ``ckpt_freq`` frames but the last (finalize writes that
        one), a culled mesh every ``mesh_freq`` frames; frame 0 has
        neither under ``no_log_on_first_frame`` /
        ``no_mesh_on_first_frame``.  It runs once the frame's record is
        logged, and the records are flushed before the checkpoint, so the
        log on disk reaches every frame a resumed run skips."""
        done = {}
        if ((not (idx == 0 and self.no_log_on_first_frame))
                and idx % self.ckpt_freq == 0 and idx != self.n_img - 1):
            self._flush_metrics()
            t0 = time.perf_counter()
            save_checkpoint(os.path.join(self.output, "ckpts",
                                         f"{idx:05d}.npz"), self, idx)
            done["checkpoint_s"] = time.perf_counter() - t0
        if (idx % self.mesh_freq == 0) and not (
                idx == 0 and self.no_mesh_on_first_frame):
            self._extract_and_cull_mesh(
                os.path.join(self.output, "mesh", f"{idx:05d}_mesh.ply"),
                upto=idx + 1, seconds=done)
        if done:
            self.bookkeeping.append({"frame": idx, **done})
            if self.verbose:
                print(f"frame {idx}: {done}")

    def _touch_heartbeat(self, idx: int) -> None:
        """Rewrite ``<output>/HEARTBEAT`` (the frame and the time): every
        frame, and at each step of finalize, whose checkpoint and mesh
        take seconds; ``run_torch.py --supervise --hang-timeout`` reads
        its age.  Rank 0's."""
        if not self.proc0:
            return
        with open(os.path.join(self.output, "HEARTBEAT"), "w") as f:
            f.write(f"{idx} {time.time()}\n")

    def _beat(self, idx: int) -> None:
        """The heartbeat, and the fault hook the restart tests drive:
        ``MYSLAM_FAULT_KILL="<frame>[:procid]"`` ends the process of
        rank ``procid`` (default 0) with exit code 21 at the first frame
        at or after ``<frame>``, once: ``<output>/FAULT_INJECTED`` keeps
        the restarted run alive."""
        self._touch_heartbeat(idx)
        fault = os.environ.get("MYSLAM_FAULT_KILL")
        if fault:
            parts = fault.split(":")
            marker = os.path.join(self.output, "FAULT_INJECTED")
            if (idx >= int(parts[0])
                    and (int(parts[1]) if len(parts) > 1 else 0)
                    == distributed.rank()
                    and not os.path.exists(marker)):
                with open(marker, "w") as f:
                    f.write(f"{idx}\n")
                os._exit(21)

    # -- main loop -------------------------------------------------------------

    def run(self, start_idx: int = 0, finalize: bool = True) -> None:
        """The loop, then (by default) the final checkpoint and mesh.
        Callers that report the loop's metrics first (bench_torch.py)
        pass ``finalize=False`` and call :meth:`finalize` themselves."""
        self.run_loop(start_idx)
        if finalize:
            self.finalize()

    def run_loop(self, start_idx: int = 0) -> None:
        """Track and map every frame of the dataset from ``start_idx``."""
        self._reset_metrics(start_idx)
        stage = self.device if self.device.type == "cuda" else None
        for idx, pkt in PacketPrefetcher(
                self.dataset, range(start_idx, self.n_img),
                self._make_packet, stage=stage):
            t_frame = time.perf_counter()
            self._beat(idx)
            wait_staged(pkt)
            self.frame_start_wall.append(t_frame)
            self.gt_poses[idx] = pkt.gt_c2w
            rec = {"frame": idx}
            self.frame_log.append(rec)
            deferred = False
            if idx == 0 or self.gt_camera:
                if not np.isfinite(pkt.gt_c2w).all():
                    raise ValueError(f"frame {idx}: the ground-truth pose "
                                     "the run starts from is not finite")
                self.est[idx] = self._to_dev(pkt.gt_c2w)
            else:
                self._track_buf.append((idx, pkt, rec))
                deferred = True
            mapped = idx % self.every_frame == 0 or idx == self.n_img - 1
            if mapped:
                # The group's poses must be in the trajectory before the
                # mapping window is assembled.
                self._flush_track_buf(open_rec=rec)
                deferred = False
                self._map_frame(idx, pkt, rec)
                if self.on_map_done is not None:
                    self.on_map_done(self, idx)
            if idx == self.sync_after_frame:
                self._flush_track_buf(open_rec=rec)
                deferred = False
                self._sync()
            self.frame_times.append(time.perf_counter() - t_frame)
            rec["frame_ms"] = self.frame_times[-1] * 1e3
            if not deferred:
                self._log_metrics(rec)
            if mapped:
                self._post_map(idx)
        self._flush_track_buf()
        self._sync()
        self.drain_wall = time.perf_counter()
        self._flush_metrics()

    def resume(self, ckpt_path: str | None = None) -> int:
        """Restore the given checkpoint, or the newest one under
        ``<output>/ckpts``; returns the frame to start from (0 if there
        is none).  In a multi-rank run rank 0 decides, from its own
        arguments and folder, and every rank loads the path it
        broadcasts (a sharded store keeps its own slots)."""
        path = None
        if self.proc0:
            path = ckpt_path or latest_checkpoint(
                os.path.join(self.output, "ckpts"))
        path = distributed.broadcast_object(path)
        if path is None:
            return 0
        start = load_checkpoint(path, self)
        if self.verbose:
            print(f"Resumed from {path} at frame {start}")
        return start

    @property
    def mesh_name(self) -> str:
        return ("final_mesh_eval_rec.ply" if self.eval_rec
                else "final_mesh.ply")

    def _extract_and_cull_mesh(self, path: str, upto: int,
                               seconds: dict | None = None) -> str | None:
        """Extract the current mesh to ``path`` and cull it with frames
        [0, upto) at their estimated poses; returns the culled copy.
        The two steps' seconds go into ``seconds`` (``mesh``, ``cull``).
        Rank 0 meshes (a sharded store's imagery gathered first, by every
        rank); the others return None."""
        store = self.store.full_view()
        if not self.proc0:
            return None
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t0 = time.perf_counter()
        self.mesher.get_mesh(path, self.map_state, store)
        t1 = time.perf_counter()
        # The prefetch thread reads the frames while the device culls.
        frames = ((d, p) for _, (c, d, p) in
                  Prefetcher(self.dataset, range(upto)))
        out = cull_mesh(path, self.cfg, frames,
                        estimate_c2w_list=self.estimates[:upto],
                        device=self.device)
        if seconds is not None:
            seconds.update(mesh=t1 - t0, cull=time.perf_counter() - t1)
        return out

    def finalize(self, mesh: bool = True,
                 checkpoint: bool = True) -> str | None:
        """Post-loop outputs: the final checkpoint,
        ``<output>/ckpts/<n-1:05d>.npz``, then the final mesh,
        ``<output>/mesh/final_mesh.ply`` (``final_mesh_eval_rec.ply`` in
        eval_rec mode) and its culled copy (``final_mesh``).  Returns the
        checkpoint's path.  A meshing failure raises: the checkpoint is
        already on disk by then, so the trajectory is safe.  The
        heartbeat is rewritten at each step.  (The JAX package drops its
        compiled programs before meshing long runs, ``jax.clear_caches``;
        eager PyTorch holds none.)"""
        ckpt = None
        last = self.n_img - 1
        self._touch_heartbeat(last)
        t0 = time.perf_counter()
        if checkpoint and self.n_img > 0:
            ckpt = save_checkpoint(
                os.path.join(self.output, "ckpts", f"{last:05d}.npz"),
                self, last)
        self.finalize_seconds = {"checkpoint": time.perf_counter() - t0}
        self._touch_heartbeat(last)
        if mesh:
            self.final_mesh = self._extract_and_cull_mesh(
                os.path.join(self.output, "mesh", self.mesh_name),
                upto=self.n_img, seconds=self.finalize_seconds)
            self._touch_heartbeat(last)
        self._flush_metrics()
        return ckpt

    @property
    def fps(self) -> float:
        total = sum(self.frame_times)
        return len(self.frame_times) / total if total > 0 else 0.0

    @staticmethod
    def _build_seconds() -> float:
        return cuda_sample.BUILD_SECONDS + imageio.BUILD_SECONDS

    @property
    def compile_secs(self) -> float:
        """Seconds spent building the kernels and the image codec since
        this system was made (0 when both were already built, or built
        earlier in the process)."""
        return self._build_seconds() - self._build_seconds_at_start

    @property
    def estimates(self) -> np.ndarray:
        return self.est.detach().cpu().numpy()

    def ate(self) -> dict:
        """ATE of the tracked trajectory against the ground truth."""
        return evaluate_run(self.estimates, self.gt_poses,
                            float(self.cfg.get("scale", 1)))
