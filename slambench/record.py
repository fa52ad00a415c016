"""What the benchmark records of a run, by wrapping the program's entry
points from the benchmark's own files (the program is not edited).

  * ``StepRecorder`` wraps the system's group tracker and frame mappers,
    and the mapper module's ``make_map_optimizer``.  For the one group the
    check follows it keeps the map the step started from, the program's
    random draws, the map and the window's poses before the first mapping
    iteration and after each (the program's own optimizer's step,
    wrapped) and what the step returned; it also marks each call as
    a span for the trace.
  * ``KernelCalls`` wraps the sample's K1 and K2 entry points while the
    trace runs: each forward call's points are copied into one buffer
    (one device copy, no host read) and the call's size is noted, so that
    the roofline's bytes can be counted from the points afterwards.
  * ``Prefetchers`` keeps the loop's prefetch threads, so that the run
    can end them.
"""

from __future__ import annotations

import torch

from slambench import counts


class HostStash:
    """Copies of device tensors in one host buffer (pinned where the
    device is a GPU), allocated at set-up: each copy is one non-blocking
    copy in stream order, so recording takes no device memory (the run's
    peak stays the program's) and waits for nothing.  Read the copies
    only after a device drain."""

    ALIGN = 64

    def __init__(self, nbytes: int, device):
        self.buf = torch.empty((int(nbytes),), dtype=torch.uint8,
                               pin_memory=torch.device(device).type
                               == "cuda")
        self.off = 0

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        n = t.numel() * t.element_size()
        if self.off + n > self.buf.numel():
            raise RuntimeError("the recording stash is too small")
        out = self.buf[self.off:self.off + n].view(t.dtype).view(t.shape)
        out.copy_(t, non_blocking=True)
        self.off += -(-n // self.ALIGN) * self.ALIGN
        return out


def map_bytes(ms) -> int:
    return sum(p.numel() * p.element_size() for p in
               [ms.sdf_atlas, ms.color_atlas, *ms.decoder.parameters()])


def clone_map(ms, keep) -> dict:
    """The map's leaves copied by ``keep`` (a HostStash, say): the two
    atlases and the decoders."""
    with torch.no_grad():
        out = {"planes": keep(ms.sdf_atlas), "planes_c": keep(ms.color_atlas)}
        out["dec"] = {n: keep(p) for n, p in ms.decoder.named_parameters()}
    return out


class RecordingDraws:
    """Passes a draw source's draws through and keeps a copy of each (by
    ``keep``), in order."""

    def __init__(self, base, keep):
        self.base = base
        self.keep = keep
        self.kept: list = []

    def uniform(self, shape):
        t = self.base.uniform(shape)
        self.kept.append(self.keep(t))
        return t

    def randint(self, shape, low, high):
        t = self.base.randint(shape, low, high)
        self.kept.append(self.keep(t))
        return t


def span(name: str):
    """A profiler span around a call into the program."""
    return torch.profiler.record_function(name)


class StepRecorder:
    """Wraps ``slam.group_tracker`` and ``slam._mappers``; records the
    group whose mapped frame is ``check_frame`` (see the module's
    docstring) into a host stash sized from the configuration."""

    def __init__(self, slam, check_frame: int, every_frame: int,
                 mapper_module):
        self.slam = slam
        self.keep = HostStash(stash_bytes(slam.cfg, slam.map_state,
                                          slam.store.capacity, every_frame),
                              slam.device)
        keep = self.keep
        self.check_frame = int(check_frame)
        self.track_idx0 = self.check_frame - every_frame + 1
        self.track = None
        self.map = None
        tracker = slam.group_tracker

        def group_tracker(ms, est, idx0, px_i, px_j, px_color, px_depth,
                          draws):
            if idx0 != self.track_idx0 or self.track is not None:
                with span("slambench.track"):
                    return tracker(ms, est, idx0, px_i, px_j, px_color,
                                   px_depth, draws)
            rec = {"idx0": int(idx0), **clone_map(ms, keep),
                   "px_i": keep(px_i), "px_j": keep(px_j)}
            rd = RecordingDraws(draws, keep)
            with span("slambench.track"):
                out = tracker(ms, est, idx0, px_i, px_j, px_color, px_depth,
                              rd)
            _, first, best, iter_poses = out
            rec.update(draws=rd.kept, loss_first=keep(first),
                       loss_best=keep(best), iter_poses=keep(iter_poses))
            self.track = rec
            return out

        slam.group_tracker = group_tracker
        for imp, mapper in list(slam._mappers.items()):
            slam._mappers[imp] = self._wrap_mapper(mapper, imp)
        # The mapping steps' states: the program's optimizer over the map
        # and the window's poses, its step wrapped to keep them, while the
        # checked frame maps.
        self.mod = mapper_module
        self.make_opt = mapper_module.make_map_optimizer
        self.steps: dict | None = None

        def make_map_optimizer(cfg, ms, poses, lr_factor):
            opt = self.make_opt(cfg, ms, poses, lr_factor)
            rec = self.steps
            if rec is None or rec["opt"] is not None:
                return opt
            rec["opt"] = opt
            step = opt.step

            def step_and_keep(*a, **k):
                out = step(*a, **k)
                rec["states"].append(clone_map(ms, keep))
                rec["poses"].append(keep(poses))
                return out

            rec["states"].append(clone_map(ms, keep))
            rec["poses"].append(keep(poses))
            opt.step = step_and_keep
            return opt

        mapper_module.make_map_optimizer = make_map_optimizer

    def restore(self) -> None:
        self.mod.make_map_optimizer = self.make_opt

    def _wrap_mapper(self, mapper, importance: bool):
        keep = self.keep

        def map_frame(ms, store, est, *args, **kw):
            idx = args[4] if len(args) > 4 else None
            if (idx != self.check_frame or self.map is not None
                    or getattr(store, "host_mode", False)):
                with span("slambench.map"):
                    return mapper(ms, store, est, *args, **kw)
            args = list(args)
            rd = RecordingDraws(args[5], keep)
            args[5] = rd
            self.steps = {"opt": None, "states": [], "poses": []}
            rec = {"idx": int(idx), "count": int(store.count),
                   "capacity": int(store.capacity),
                   "importance": bool(importance),
                   "iters": int(kw["iters"]),
                   "lr_factor": float(kw["lr_factor"]),
                   "joint_opt": bool(kw["joint_opt"]),
                   "admit": bool(kw["admit"]),
                   "packed": bool(store.packed),
                   "est_c2w_before": keep(store.est_c2w),
                   "cur_c2w": keep(est[idx])}
            try:
                with span("slambench.map"):
                    losses = mapper(ms, store, est, *args, **kw)
                steps = self.steps
            finally:
                self.steps = None
            if len(steps["states"]) != int(kw["iters"]) + 1:
                raise RuntimeError("the checked mapping frame's optimizer "
                                   "was not seen at each step")
            rec.update(draws=rd.kept, states=steps["states"],
                       poses=steps["poses"], losses=keep(losses),
                       est_c2w_after=keep(store.est_c2w),
                       cur_after=keep(est[idx]))
            self.map = rec
            return losses

        return map_frame


def stash_bytes(cfg: dict, ms, capacity: int, every_frame: int) -> int:
    """Bytes the checked group's record takes, with room: the map before
    tracking and before, during and after mapping, the draws (tracking's
    jitter, the window's and mapping's pixels and uniforms), the tracking
    pixels, the poses (the window's at each mapping step)."""
    r, t, m = cfg["rendering"], cfg["tracking"], cfg["mapping"]
    s = int(r["n_stratified"]) + int(r["n_importance"])
    nt, it = int(t["pixels"]), int(t["iters"])
    nm, im = int(m["pixels"]), int(m["iters"])
    track = every_frame * it * nt * (4 * s + 2 * 8)
    draws = 2 * 50 * 8 + capacity * 4 + im * nm * (
        2 * 8 + 4 * s + 4 * int(r["n_stratified"]) + 4 * int(
            r["n_importance"]))
    maps = (im + 3) * map_bytes(ms)
    window = (im + 1) * 4 * 7 * (int(m["mapping_window_size"]) + 2)
    return int(1.25 * (track + draws + maps + window + 4 * capacity * 64)
               ) + (1 << 20)


class KernelCalls:
    """Records K1's and K2's calls while ``active`` (see the module's
    docstring).  ``capacity`` points fit the buffer; past it, ``full``
    is set and nothing more is kept."""

    def __init__(self, cuda_sample, capacity: int, device):
        self.mod = cuda_sample
        self.fwd, self.bwd = cuda_sample.plane_sample_fwd, \
            cuda_sample.plane_sample_bwd
        self.buf = torch.empty((int(capacity), 3), dtype=torch.float32,
                               device=device)
        self.used = 0
        self.full = False
        self.active = False
        self.calls: list[dict] = []
        self._by_ptr: dict = {}
        cuda_sample.plane_sample_fwd = self._fwd
        cuda_sample.plane_sample_bwd = self._bwd

    def restore(self) -> None:
        self.mod.plane_sample_fwd, self.mod.plane_sample_bwd = self.fwd, \
            self.bwd

    def _keep(self, p_nor, layout) -> int | None:
        n = p_nor.shape[0]
        if self.full or self.used + n > self.buf.shape[0]:
            self.full = True
            return None
        off = self.used
        self.buf[off:off + n].copy_(p_nor)
        self.used += n
        self._by_ptr[p_nor.data_ptr()] = off
        return off

    @staticmethod
    def _planes(layout):
        return tuple((au, av, H, W) for _, _, au, av, H, W, _ in
                     layout.planes())

    def _fwd(self, quad, layout, p_nor):
        if self.active:
            off = self._keep(p_nor, layout)
            self.calls.append({"kind": "fwd", "off": off,
                               "n": p_nor.shape[0],
                               "planes": self._planes(layout),
                               "c_dim": layout.c_dim,
                               "elt": quad.element_size()})
        return self.fwd(quad, layout, p_nor)

    def _bwd(self, gbar, quad, layout, p_nor, need_quad_grad=True):
        if self.active:
            off = self._by_ptr.get(p_nor.data_ptr())
            if off is None:
                off = self._keep(p_nor, layout)
            self.calls.append({"kind": "bwd", "off": off,
                               "n": p_nor.shape[0],
                               "planes": self._planes(layout),
                               "c_dim": layout.c_dim,
                               "elt": quad.element_size(),
                               "quad_grad": bool(need_quad_grad)})
        return self.bwd(gbar, quad, layout, p_nor,
                        need_quad_grad=need_quad_grad)

    def bounds(self) -> dict | None:
        """Summed least milliseconds of the recorded K1 and K2 calls, and
        their counts; None when a call's points were not kept."""
        if self.full or any(c["off"] is None for c in self.calls):
            return None
        rows = {}
        for c in self.calls:
            key = (c["off"], c["planes"])
            if key not in rows:
                rows[key] = counts.touched_rows(
                    self.buf[c["off"]:c["off"] + c["n"]], c["planes"])
        host = dict(zip(rows, torch.stack(list(rows.values())).cpu()
                        .tolist())) if rows else {}
        out = {"fwd_ms": 0.0, "bwd_ms": 0.0, "fwd_calls": 0, "bwd_calls": 0}
        for c in self.calls:
            r = host[(c["off"], c["planes"])]
            if c["kind"] == "fwd":
                ms, _ = counts.bound_ms(*counts.fwd_work(
                    c["n"], c["c_dim"], r, c["elt"]))
            else:
                ms, _ = counts.bound_ms(*counts.bwd_work(
                    c["n"], c["c_dim"], r, c["elt"], c["quad_grad"]))
            out[c["kind"] + "_ms"] += ms
            out[c["kind"] + "_calls"] += 1
        return out


class Prefetchers:
    """Replaces the scheduler's ``PacketPrefetcher`` by a factory that
    keeps each one it makes."""

    def __init__(self, scheduler_module):
        self.mod = scheduler_module
        self.cls = scheduler_module.PacketPrefetcher
        self.made: list = []

        def make(*args, **kw):
            p = self.cls(*args, **kw)
            self.made.append(p)
            return p

        scheduler_module.PacketPrefetcher = make

    def restore(self) -> None:
        self.mod.PacketPrefetcher = self.cls

    def end(self, timeout: float = 120.0) -> None:
        """Drain each prefetcher's queue until its thread has put its last
        item (the frame source, once closed, makes it stop), then join
        the thread."""
        for p in self.made:
            while p.thread.is_alive():
                try:
                    item = p.q.get(timeout=timeout)
                except Exception:
                    break
                if item is None or isinstance(item, Exception):
                    break
            p.thread.join(timeout)
