"""The track||map pipeline: tracking and mapping as two roles of the gang.

The port of ``parallel.pipeline`` (``myslam_tpu/engine/scheduler.py``,
``_map_frame_pipeline`` and the run loop's exchanges).  Ranks
``0..n_track-1`` track (ray DP among them when there are several), the
next ``n_map`` ranks map (ray DP among them: the frame mapper's
``sharded`` path over the map role's group).  Per mapped frame (a
boundary) b:

  * the track role tracks the frames since the previous boundary
    against its map snapshot and sends their poses to the map role
    (``poses``: the track lead to the map lead, broadcast over the map
    role), which writes them as rows of its own trajectory;
  * the map role then sends the track role its map as of the previous
    boundary (``snapshot``: the atlases and the decoder, the map lead to
    the track lead, broadcast over the track role) and maps b.  At frame
    0 of a fresh run it sends the map after mapping frame 0 instead:
    tracking waits for the first map.

So the tracking group after boundary b renders against the map as of
the boundary before b, while the map role maps b: the two roles
overlap, and the map role never waits for tracking longer than the
poses it needs.  Both transfers are non-blocking point-to-point sends
from host copies (``distributed.isend``).  The map role's trajectory,
with joint BA's refinements, is the run's trajectory at the end.

Random draws do not depend on timing: the map role draws from the run's
draw source alone, and each tracking group from a source seeded with
the run's seed, ``TRACK_SEED_OFFSET`` and the group's first frame.

In a process group of one rank, one process plays both roles in the
same order, with local copies for transfers (``PipelineLink(local)``):
the same schedule, the 2-rank pipeline's result bit for bit on the CPU.

The map role writes the checkpoints and meshes, into rank 0's output
folder, and the mapped frames' records (``metrics_map.jsonl``); rank 0
writes the tracked frames' records (``metrics.jsonl``) and the
heartbeat.  A checkpoint also holds what the track role needs to go on
from it exactly: its trajectory rows (``pipeline_track_est``) and its
map snapshot (``pipeline_snapshot``).
"""

from __future__ import annotations

import copy

import torch

from myslam_torch.models.planes import MapState
from myslam_torch.parallel import distributed

# Tracking draws of the group starting at frame f come from a source
# seeded with seed + TRACK_SEED_OFFSET + f.
TRACK_SEED_OFFSET = 104729


def boundaries(start: int, n_img: int, every_frame: int) -> list[int]:
    """The mapped frames from ``start`` on."""
    return [i for i in range(start, n_img)
            if i % every_frame == 0 or i == n_img - 1]


def map_tensors(ms: MapState) -> list[torch.Tensor]:
    """The map's tensors in the snapshot's order: the two atlases, then
    the decoder's parameters."""
    return [ms.sdf_atlas, ms.color_atlas, *ms.decoder.parameters()]


@torch.no_grad()
def pack_map(ms: MapState) -> torch.Tensor:
    """The map as one flat float32 tensor (the snapshot's bytes)."""
    return torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in map_tensors(ms)])


@torch.no_grad()
def unpack_map(flat: torch.Tensor, ms: MapState) -> None:
    """Copy a flat snapshot into the map ``ms`` in place."""
    flat = flat.to(ms.sdf_atlas.device)
    off = 0
    for t in map_tensors(ms):
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def snapshot_numel(ms: MapState) -> int:
    return sum(t.numel() for t in map_tensors(ms))


class PipelineLink:
    """The two roles' ranks and their exchanges.

    ``local`` (a process group of one rank): this process is both roles
    and the transfers are copies, in the same order as the gang's.
    Otherwise the groups ``track_group`` (global ranks 0..n_track-1) and
    ``map_group`` (the next n_map) are made here, on every rank, in that
    order."""

    def __init__(self, n_track: int, n_map: int):
        self.local = distributed.global_world() == 1
        self.n_track, self.n_map = int(n_track), int(n_map)
        self.track_lead, self.map_lead = 0, self.n_track
        if self.local:
            self.track_group = self.map_group = None
            self.is_track = self.is_map = True
        else:
            self.track_group = distributed.new_group(range(self.n_track))
            self.map_group = distributed.new_group(
                range(self.n_track, self.n_track + self.n_map))
            me = distributed.global_rank()
            self.is_track = me < self.n_track
            self.is_map = not self.is_track
        self._rows: list = []       # local transfers in flight
        self._snaps: list = []
        self._sends: list = []      # the gang's sends in flight
        self._snap_recv = None      # the snapshot receive in flight
        self._snap_left = 0         # snapshots the track role will take
        self._snap_numel = 0
        # The map role's last snapshot sent: the map the track role
        # holds until the next boundary (a checkpoint keeps it).
        self.last_snapshot: torch.Tensor | None = None

    def _wait_sends(self) -> None:
        for s in self._sends:
            s.wait()
        self._sends = []

    def expect_snapshots(self, n: int, numel: int) -> None:
        """The track role will take ``n`` snapshots of ``numel`` floats
        in this run; the first receive is posted now."""
        self._snap_left, self._snap_numel = int(n), int(numel)
        self._post_snapshot_recv()

    def _post_snapshot_recv(self) -> None:
        if (not self.local and self.is_track and self._snap_left > 0
                and distributed.global_rank() == self.track_lead):
            self._snap_recv = distributed.irecv(
                (self._snap_numel,), torch.float32, self.map_lead,
                "snapshot")

    # -- the track role ---------------------------------------------------

    def send_poses(self, rows: torch.Tensor) -> None:
        """The group's tracked poses (G, 4, 4), to the map role."""
        if self.local:
            self._rows.append(rows.detach().clone())
        elif distributed.global_rank() == self.track_lead:
            self._sends.append(distributed.isend(rows, self.map_lead,
                                                 "poses"))

    def take_snapshot(self, into: MapState) -> None:
        """The next snapshot, copied into the track role's map."""
        if self.local:
            flat = self._snaps.pop(0)
        else:
            if distributed.global_rank() == self.track_lead:
                flat = self._snap_recv.wait()
            else:
                flat = torch.empty((self._snap_numel,), dtype=torch.float32)
            with distributed.scope(self.track_group):
                distributed.broadcast_(flat, 0, "snapshot")
            self._snap_left -= 1
            self._post_snapshot_recv()
        unpack_map(flat, into)

    # -- the map role -----------------------------------------------------

    def recv_poses(self, n: int, device) -> torch.Tensor:
        """The track role's next n poses (n, 4, 4) on ``device``."""
        if self.local:
            return self._rows.pop(0).to(device)
        if distributed.global_rank() == self.map_lead:
            rows = distributed.irecv((n, 4, 4), torch.float32,
                                     self.track_lead, "poses").wait()
        else:
            rows = torch.empty((n, 4, 4), dtype=torch.float32)
        with distributed.scope(self.map_group):
            distributed.broadcast_(rows, 0, "poses")
        return rows.to(device)

    def post_snapshot(self, ms: MapState) -> None:
        """The map ``ms`` as it is now, to the track role."""
        flat = pack_map(ms).cpu()
        self.last_snapshot = flat
        if self.local:
            self._snaps.append(flat.clone())
        elif distributed.global_rank() == self.map_lead:
            self._wait_sends()
            self._sends.append(distributed.isend(flat, self.track_lead,
                                                 "snapshot"))

    def close(self) -> None:
        """Wait for every send in flight."""
        self._wait_sends()


@torch.no_grad()
def copy_map(ms: MapState) -> MapState:
    """A copy of the map with a decoder of its own (the track role's)."""
    return MapState(sdf_atlas=ms.sdf_atlas.detach().clone(),
                    color_atlas=ms.color_atlas.detach().clone(),
                    decoder=copy.deepcopy(ms.decoder))
