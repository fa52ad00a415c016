"""The process group of a multi-process run, and its counted collectives.

The port of ``myslam_tpu/parallel/distributed.py`` on torch.distributed.
One rank is one process and one device: rank r runs on
``cuda:(r % device_count)`` unless the CPU is asked for (``rank_device``).

The backend follows one rule (``backend_for``):

  * ``nccl`` where every rank has a GPU of its own (NCCL refuses two ranks
    on one GPU);
  * ``gloo`` where ranks share a GPU, and on the CPU.

gloo takes the CUDA tensors as they are: it copies them to the host and
back inside the call, so no rank stages them itself.  Every process group
is made with an explicit timeout (``TIMEOUT_S``), so a rank that waits on
a dead peer fails instead of hanging.

Every collective goes through the functions below, which count its calls,
bytes and seconds by kind in ``COUNTS`` (``reset_counts``): ``grad`` for
the one flat gradient all-reduce per mapping step, ``loss`` for the
mapping losses' masked (sum, count) pairs, ``track_median``,
``track_loss`` and ``track_grad`` for tracking's outlier threshold,
losses and pose gradient, ``schur`` for the reduced pose system,
``store`` for keyframe imagery gathered to rank 0 for a checkpoint or
a mesh, ``object`` for small host values (the resume decision),
``barrier``.  Seconds are host seconds from the device's last queued
work to the call's return.
"""

from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist

# Seconds a rank waits on a collective before it fails.
TIMEOUT_S = 300.0

COUNTS: dict = {}


def reset_counts() -> None:
    COUNTS.clear()


def _count(kind: str, nbytes: int, seconds: float) -> None:
    rec = COUNTS.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    rec["calls"] += 1
    rec["bytes"] += int(nbytes)
    rec["seconds"] += seconds


def rank_device(rank: int, device=None) -> torch.device:
    """The device of ``rank``: the CPU when ``device`` says so, else
    ``cuda:(rank % device_count)`` (``device`` None or ``cuda``) or the
    device given."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is None or str(device) == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device visible; pass device='cpu'")
        return torch.device("cuda", rank % n)
    return torch.device(device)


def backend_for(device, world_size: int) -> str:
    """``nccl`` where every rank has a GPU of its own, else ``gloo``."""
    device = torch.device(device)
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(coordinator: str | None, num_processes: int,
                     process_id: int, device=None,
                     timeout_s: float | None = None) -> str | None:
    """Join the process group of ``num_processes`` ranks at
    ``coordinator`` (``host:port``) as rank ``process_id``; a no-op for
    one process.  Returns the backend (None for one process)."""
    if num_processes is None or num_processes <= 1:
        return None
    dev = rank_device(process_id, device)
    backend = backend_for(dev, num_processes)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(
            seconds=TIMEOUT_S if timeout_s is None else timeout_s))
    return backend


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world() -> int:
    return dist.get_world_size() if initialized() else 1


def backend() -> str | None:
    return dist.get_backend() if initialized() else None


def host_shard(n: int) -> tuple[int, int]:
    """This rank's [start, end) share of n items (contiguous, the last
    share the shortest)."""
    per = -(-n // world())
    r = rank()
    return min(r * per, n), min((r + 1) * per, n)


def barrier() -> None:
    """A fence across the ranks (no-op for one process)."""
    if world() > 1:
        t0 = time.perf_counter()
        dist.barrier()
        _count("barrier", 0, time.perf_counter() - t0)


def shutdown() -> None:
    """Leave the process group."""
    if initialized():
        dist.destroy_process_group()


def _start(t: torch.Tensor) -> float:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def all_reduce_(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (one call); returns it."""
    if world() == 1:
        return t
    t0 = _start(t)
    dist.all_reduce(t)
    _count(kind, t.numel() * t.element_size(), time.perf_counter() - t0)
    return t


def all_gather(t: torch.Tensor, kind: str) -> torch.Tensor:
    """The ranks' ``t`` stacked in rank order, (world, *t.shape).  The
    bytes travel as uint8 (gloo takes no uint16 or int16)."""
    if world() == 1:
        return t[None]
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(world())]
    t0 = _start(t)
    dist.all_gather(parts, raw)
    _count(kind, raw.numel() * world(), time.perf_counter() - t0)
    return torch.stack(parts).view(t.dtype).reshape((world(),) + t.shape)


def gather_to_rank0(t: torch.Tensor, kind: str) -> list | None:
    """The ranks' ``t`` in rank order on rank 0, each of ``t``'s shape
    and dtype; None on the other ranks, which allocate nothing on their
    device.  The bytes travel as uint8; under gloo (which gathers host
    memory) through the host, where rank 0's parts stay, so that the
    caller copies each into place without a second device copy of the
    whole."""
    if world() == 1:
        return [t]
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    if backend() == "gloo":
        raw = raw.cpu()
    parts = ([torch.empty_like(raw) for _ in range(world())]
             if rank() == 0 else None)
    t0 = _start(t)
    dist.gather(raw, parts, dst=0)
    _count(kind, raw.numel() * world(), time.perf_counter() - t0)
    if parts is None:
        return None
    return [q.view(t.dtype).reshape(t.shape) for q in parts]


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (a small picklable value) on every rank."""
    if world() == 1:
        return obj
    box = [obj]
    t0 = time.perf_counter()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend() == "nccl" else None)
    dist.broadcast_object_list(box, src=src, device=dev)
    _count("object", 0, time.perf_counter() - t0)
    return box[0]


def all_reduce_grads(params) -> int:
    """Sum the gradients of ``params`` over the ranks as one flat float32
    buffer in one call (a parameter without a gradient contributes
    zeros); returns the buffer's bytes."""
    params = list(params)
    if world() == 1:
        return 0
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    all_reduce_(flat, "grad")
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p)
        off += n
    return flat.numel() * flat.element_size()
