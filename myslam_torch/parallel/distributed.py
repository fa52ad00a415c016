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

Subgroups (``new_group``: the pipeline's two roles, the kf rows and dp
columns of a (K, D) grid, a store's gather ranks) are made on every rank
in the same order.  ``scope(group)`` makes a group the current one:
inside it ``rank()``, ``world()`` and every collective below refer to
that group, so a mapper or tracker written for "the ranks" runs over a
role's ranks unchanged; outside any scope they refer to the whole
process group.  ``global_rank()`` is the rank in the whole group.

Every collective goes through the functions below, which count its calls,
bytes and seconds by kind in ``COUNTS`` (``reset_counts``): ``grad`` for
the one flat gradient all-reduce per mapping step, ``grad_rs`` and
``zero_gather`` for the row-sharded Adam's (``dp_impl: spmd`` with
``zero_opt``) gradient reduction and the all-gather of the updated atlas
rows (``reduce_grads_rows``, ``all_gather_rows``), ``loss`` for the
mapping losses' masked (sum, count) pairs, ``track_median``,
``track_loss`` and ``track_grad`` for tracking's outlier threshold,
losses and pose gradient, ``schur`` for the reduced pose system,
``store`` for keyframe imagery gathered to rank 0 for a checkpoint or
a mesh, ``object`` for small host values (the resume decision),
``barrier``; for banded map shards ``halo`` (a band's first rows sent to
the rank above, and their gradient sent back), ``features`` (the
all-reduce of each sample call's partial features), ``coord_grad`` (the
all-reduce of the sample's coordinate gradient) and ``bands`` (the
all-gather of the bands after a mapped frame); for the pipeline
``poses`` (a group's tracked poses, track role to map role) and
``snapshot`` (the map, map role to track role).  Seconds are host
seconds from the device's last queued work to the call's return; for a
point-to-point transfer, the seconds its ``wait`` blocked.

The row-sharded Adam's reduction is one ``reduce_scatter_tensor`` on
every backend (gloo's through the host, as ``comm_device`` says).  On 2
ranks each summed element is a + b in either order, so the update equals
the replicated Adam's bit for bit; on more ranks the reduce-scatter may
sum in another order than the all-reduce.
"""

from __future__ import annotations

import contextlib
import datetime
import time

import torch
import torch.distributed as dist

# Seconds a rank waits on a collective before it fails.
TIMEOUT_S = 300.0

COUNTS: dict = {}
# When a list, every counted call is also appended to it as (kind, bytes,
# seconds): the sizes and times of single calls (chip_smoke.py).
TRACE: list | None = None


def reset_counts() -> None:
    COUNTS.clear()


def _count(kind: str, nbytes: int, seconds: float) -> None:
    rec = COUNTS.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    rec["calls"] += 1
    rec["bytes"] += int(nbytes)
    rec["seconds"] += seconds
    if TRACE is not None:
        TRACE.append((kind, int(nbytes), seconds))


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


def global_rank() -> int:
    """This process's rank in the whole process group."""
    return dist.get_rank() if initialized() else 0


def global_world() -> int:
    """Ranks in the whole process group."""
    return dist.get_world_size() if initialized() else 1


class Group:
    """Ranks of the process group, in order: their global ranks
    (``ranks``), this process's index among them (``rank``; -1 when it
    is not a member), their count (``size``) and the torch.distributed
    group (``pg``; None for the whole process group)."""

    def __init__(self, ranks, pg=None):
        self.ranks = [int(r) for r in ranks]
        self.pg = pg
        me = global_rank()
        self.rank = self.ranks.index(me) if me in self.ranks else -1
        self.size = len(self.ranks)

    @property
    def member(self) -> bool:
        return self.rank >= 0

    def __repr__(self) -> str:
        return f"Group({self.ranks})"


def new_group(ranks) -> Group:
    """A group of the given global ranks.  Every rank of the process
    group must make every group, members or not, in the same order."""
    ranks = [int(r) for r in ranks]
    if not initialized() or ranks == list(range(global_world())):
        return Group(ranks, None)
    return Group(ranks, dist.new_group(
        ranks=ranks, timeout=datetime.timedelta(seconds=TIMEOUT_S)))


_SCOPES: list = []


@contextlib.contextmanager
def scope(group: Group | None):
    """Run the block with ``group`` as the current group (None: the
    whole process group); this rank must be a member."""
    if group is not None and not group.member:
        raise ValueError(f"rank {global_rank()} is not in {group}")
    _SCOPES.append(group)
    try:
        yield group
    finally:
        _SCOPES.pop()


def current() -> Group | None:
    """The current group (None: the whole process group)."""
    return _SCOPES[-1] if _SCOPES else None


def _pg():
    g = current()
    return None if g is None else g.pg


def rank() -> int:
    """This rank's index in the current group."""
    g = current()
    return global_rank() if g is None else g.rank


def world() -> int:
    """Ranks in the current group."""
    g = current()
    return global_world() if g is None else g.size


def to_global(r: int) -> int:
    """The global rank of the current group's rank ``r``."""
    g = current()
    return r if g is None else g.ranks[r]


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
        dist.barrier(group=_pg())
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
    dist.all_reduce(t, group=_pg())
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
    dist.all_gather(parts, raw, group=_pg())
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
    dist.gather(raw, parts, dst=to_global(0), group=_pg())
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
    dist.broadcast_object_list(box, src=to_global(src), group=_pg(),
                               device=dev)
    _count("object", 0, time.perf_counter() - t0)
    return box[0]


def all_reduce_grads(params) -> int:
    """Sum the gradients of ``params`` over the ranks as one flat float32
    buffer in one call (a parameter without a gradient contributes
    zeros); returns the buffer's bytes."""
    params = list(params)
    if world() == 1:
        return 0
    flat = _flat_grads(params)
    all_reduce_(flat, "grad")
    for p, g in zip(params, _split(flat, params)):
        p.grad = g
    return flat.numel() * flat.element_size()


def _flat_grads(params) -> torch.Tensor:
    """The gradients of ``params`` as one flat float32 buffer (zeros for
    a parameter without one)."""
    return torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])


def _split(flat: torch.Tensor, like) -> list:
    """``flat`` cut into views shaped as the tensors of ``like``."""
    out, off = [], 0
    for p in like:
        n = p.numel()
        out.append(flat[off:off + n].view_as(p))
        off += n
    return out


def reduce_grads_rows(params, sharded) -> list:
    """The gradients of ``params`` summed over the ranks, for the
    row-sharded Adam: whole for a replicated parameter, this rank's
    block of rows (``host_shard``) for one marked in ``sharded``.  One
    ``reduce_scatter_tensor`` of the sharded parameters' row blocks
    (kind ``grad_rs``) and one all-reduce of the replicated ones
    (``grad``), each only where there are such parameters.  Returns the
    gradients in the order of ``params``."""
    params = list(params)
    if world() == 1:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in params]
    shard = [p for p, s in zip(params, sharded) if s]
    rest = [p for p, s in zip(params, sharded) if not s]
    mine = iter(_reduce_scatter_rows(shard) if shard else [])
    summed = iter(_split(all_reduce_(_flat_grads(rest), "grad"), rest)
                  if rest else [])
    return [next(mine) if s else next(summed) for s in sharded]


def _reduce_scatter_rows(shard) -> list:
    """This rank's row block of each gradient of ``shard`` summed over
    the ranks, by one ``reduce_scatter_tensor``: rank r's segment of its
    input holds rank r's block of every gradient, padded to
    ``ceil(rows / world)`` rows."""
    n = world()
    per = [-(-p.shape[0] // n) for p in shard]
    seg = sum(k * p[0].numel() for k, p in zip(per, shard))
    buf = torch.zeros((n, seg), dtype=torch.float32,
                      device=shard[0].device)
    off = 0
    for k, p in zip(per, shard):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        row = p[0].numel()
        for r in range(n):
            part = g[r * k:(r + 1) * k].reshape(-1)
            buf[r, off:off + part.numel()] = part
        off += k * row
    send = buf.reshape(-1).to(comm_device())
    out = torch.empty((seg,), dtype=torch.float32, device=send.device)
    t0 = _start(buf)
    dist.reduce_scatter_tensor(out, send, group=_pg())
    _count("grad_rs", buf.numel() * buf.element_size(),
           time.perf_counter() - t0)
    out = out.to(buf.device)
    mine, off = [], 0
    for k, p in zip(per, shard):
        lo, hi = host_shard(p.shape[0])
        row = p[0].numel()
        mine.append(out[off:off + (hi - lo) * row].view(
            (hi - lo,) + tuple(p.shape[1:])))
        off += k * row
    return mine


def all_gather_rows(fulls, blocks) -> int:
    """Every rank's updated row block (``blocks``: this rank's, each
    ``host_shard`` rows of the matching tensor of ``fulls``) written into
    the full tensors on every rank, in place, by one all-gather (kind
    ``zero_gather``; each block padded to ``ceil(rows / world)`` rows).
    Returns the bytes gathered."""
    n = world()
    if n == 1 or not fulls:
        return 0
    per = [-(-f.shape[0] // n) for f in fulls]
    mine = torch.cat([torch.cat([b.reshape(-1), b.new_zeros(
        (k * f[0].numel() - b.numel(),))]) for f, b, k in
        zip(fulls, blocks, per)])
    parts = all_gather(mine, "zero_gather")
    with torch.no_grad():
        off = 0
        for f, k in zip(fulls, per):
            row = f[0].numel()
            for r in range(n):
                lo, hi = min(r * k, f.shape[0]), min((r + 1) * k,
                                                    f.shape[0])
                f[lo:hi].copy_(parts[r, off:off + (hi - lo) * row].view(
                    (hi - lo,) + tuple(f.shape[1:])))
            off += k * row
    return parts.numel() * parts.element_size()


def comm_device() -> torch.device:
    """Where the backend's transfers live: this rank's GPU under NCCL,
    the host under gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_(t: torch.Tensor, src: int, kind: str) -> torch.Tensor:
    """Rank ``src``'s ``t`` (of the current group) into ``t`` on every
    rank of the group, in place; returns it.  The bytes go through
    ``comm_device()`` (the host under gloo)."""
    if world() == 1:
        return t
    buf = t.contiguous().to(comm_device())
    t0 = _start(t)
    dist.broadcast(buf, src=to_global(src), group=_pg())
    _count(kind, buf.numel() * buf.element_size(),
           time.perf_counter() - t0)
    if buf is not t:
        with torch.no_grad():
            t.copy_(buf.view_as(t))
    return t


# Tags of the point-to-point transfers, one per kind, so that two kinds
# between the same pair of ranks never match each other's messages.
_TAGS = {"halo": 11, "poses": 12, "snapshot": 13}


class Transfer:
    """A point-to-point send or receive in flight: ``wait()`` blocks
    until it is done (adding the seconds it blocked to its kind) and
    returns the tensor; the host buffer lives until then."""

    def __init__(self, work, buf: torch.Tensor, kind: str):
        self.work, self.buf, self.kind = work, buf, kind

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            t0 = time.perf_counter()
            self.work.wait()
            COUNTS[self.kind]["seconds"] += time.perf_counter() - t0
            self.work = None
        return self.buf


def isend(t: torch.Tensor, dst: int, kind: str) -> Transfer:
    """Start sending ``t`` to global rank ``dst``.  The bytes go from a
    copy on ``comm_device()`` (the host under gloo, which sends host
    memory); the caller may change ``t`` once this returns."""
    buf = t.detach().contiguous().to(comm_device(), copy=True)
    _count(kind, buf.numel() * buf.element_size(), 0.0)
    return Transfer(dist.isend(buf, dst=int(dst), tag=_TAGS[kind]), buf,
                    kind)


def irecv(shape, dtype, src: int, kind: str) -> Transfer:
    """Start receiving a tensor of ``shape`` and ``dtype`` from global
    rank ``src`` onto ``comm_device()``; ``wait()`` returns it."""
    buf = torch.empty(tuple(shape), dtype=dtype, device=comm_device())
    _count(kind, buf.numel() * buf.element_size(), 0.0)
    return Transfer(dist.irecv(buf, src=int(src), tag=_TAGS[kind]), buf,
                    kind)
