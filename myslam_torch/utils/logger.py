"""Checkpoints: the full SLAM state in one npz, written crash-atomically.

The port of ``myslam_tpu/utils/logger.py``.  A checkpoint holds the map
atlases and decoder, both pose lists, the keyframe store's imagery as
uint8 color and uint16 depth with its dequantization scale, and the
state of the run's draw source.  The float store is quantized for the
file as the JAX package's device-store branch does it (one scale for the
checkpoint); the packed and host-staged stores already hold that format
and are written byte for byte, with a scale per keyframe.  The field
names are the JAX package's, so readers of either package's checkpoints
(trajectory evaluation, replay) read both:

  * ``decoder_leaves`` lists the decoder's arrays in the order
    ``jax.tree_util.tree_flatten`` gives the JAX decoder dict (keys
    sorted: beta, rgb, rgb_out, sdf, sdf_out; layers in order, weight
    then bias), weights as (in, out) matrices, the layout
    ``models/convert.py`` takes;
  * ``draws_generator_state`` holds the ``torch.Generator`` state of the
    draw source in place of JAX's ``rng_key``, which means nothing to
    torch.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from myslam_torch.models.convert import decoder_from_jax_numpy, \
    decoder_to_jax_numpy
from myslam_torch.parallel import distributed


def _flatten(tree) -> list:
    """Leaves of nested dicts (keys sorted) and lists, in the order of
    jax.tree_util.tree_flatten."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` in _flatten order."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return [_unflatten(v, leaves) for v in template]
    return next(leaves)


def decoder_leaves(decoder) -> list[np.ndarray]:
    """The Decoders module's float32 arrays in the JAX package's tree
    order."""
    return [np.asarray(a, np.float32)
            for a in _flatten(decoder_to_jax_numpy(decoder))]


def save_checkpoint(path: str, slam, idx: int) -> str | None:
    """Write the full SLAM state at frame ``idx`` to ``path``.

    Crash-atomic: the file is written to ``<path>.tmp.npz``, synced, then
    renamed over ``path``, so an interrupted write never leaves a
    truncated file where ``latest_checkpoint`` looks.  In a multi-rank
    run every rank calls this and rank 0 alone writes (returns None
    elsewhere); a store sharded over the ranks is gathered to rank 0
    first (``full_view``), so its file is the unsharded store's, byte for
    byte.
    """
    store = slam.store.full_view()
    if distributed.rank() != 0:
        return None
    n = store.count
    ms = slam.map_state
    if store.mode != "device":
        colors_u8, depths_u16, inv_q = (b[:n].cpu().numpy()
                                        for b in store.wire())
    else:
        with torch.no_grad():
            colors_u8 = torch.clamp(torch.round(
                store.colors[:n].to(torch.float32) * 255.0), 0, 255).to(
                    torch.uint8).cpu().numpy()
            depths = store.depths[:n]
            dmax = float(depths.max()) if n else 1.0
            dq = 60000.0 / max(dmax, 1e-3)
            # Valid (> 0) depths never quantize to 0, which means no
            # depth.
            depths_u16 = torch.where(
                depths > 0, torch.clamp(torch.round(depths * dq), 1, 65535),
                torch.zeros_like(depths)).cpu().numpy().astype(np.uint16)
        inv_q = np.float32(1.0 / dq)
    leaves = decoder_leaves(ms.decoder)
    packed_leaves = np.empty(len(leaves), dtype=object)
    packed_leaves[:] = leaves
    tmp = path + ".tmp.npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(
        tmp,
        idx=idx,
        sdf_atlas=ms.sdf_atlas.detach().cpu().numpy(),
        color_atlas=ms.color_atlas.detach().cpu().numpy(),
        decoder_leaves=packed_leaves,
        estimate_c2w_list=slam.estimates,
        gt_c2w_list=slam.gt_poses,
        keyframe_list=np.asarray(store.frame_ids[:n], np.int64),
        kf_colors_u8=colors_u8,
        kf_depths_u16=depths_u16,
        kf_depth_inv_q=inv_q,
        kf_est_c2w=store.est_c2w[:n].cpu().numpy(),
        kf_gt_c2w=store.gt_c2w[:n].cpu().numpy(),
        kf_has_depthless=np.asarray(store.has_depthless[:n], bool),
        draws_generator_state=slam.draws.generator.get_state().numpy(),
        allow_pickle=True,
    )
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def restore_map(data, ms) -> None:
    """Copy a checkpoint's map (``sdf_atlas``, ``color_atlas``,
    ``decoder_leaves``, in the JAX package's tree order) into the
    MapState ``ms``."""
    tree = _unflatten(decoder_to_jax_numpy(ms.decoder),
                      iter(list(data["decoder_leaves"])))
    with torch.no_grad():
        ms.sdf_atlas.copy_(torch.from_numpy(np.asarray(data["sdf_atlas"])))
        ms.color_atlas.copy_(torch.from_numpy(
            np.asarray(data["color_atlas"])))
        ms.decoder.load_state_dict(decoder_from_jax_numpy(tree).state_dict())


def load_checkpoint(path: str, slam) -> int:
    """Restore a checkpoint into a freshly constructed SLAMSystem of the
    same configuration; returns the first frame still to process.

    Atlases, decoder, pose lists, keyframe colors and the draw source
    come back bit for bit; the packed and host-staged stores' imagery
    too, the float store's depths within half their quantization step
    (``kf_depth_inv_q``).  A store sharded over ranks takes its own
    slots' imagery from the file and leaves the rest.
    """
    with np.load(path, allow_pickle=True) as npz:
        data = dict(npz)
    ms = slam.map_state
    dev = ms.sdf_atlas.device
    restore_map(data, ms)
    with torch.no_grad():
        slam.est.copy_(torch.from_numpy(data["estimate_c2w_list"]))
    slam.gt_poses = np.array(data["gt_c2w_list"], np.float32)

    store = slam.store
    frame_ids = data["keyframe_list"]
    n = len(frame_ids)
    inv_q = np.broadcast_to(np.asarray(data["kf_depth_inv_q"], np.float32),
                            (n,))
    colors_u8 = torch.from_numpy(data["kf_colors_u8"])
    depths_u16 = torch.from_numpy(data["kf_depths_u16"])
    inv_q_t = torch.from_numpy(inv_q.copy())
    # The file's slots [lo, hi) land in this store's imagery rows
    # [lo - offset, hi - offset): all of [0, n) unsharded.
    lo = min(store.slot_offset, n)
    hi = min(store.slot_offset + store.local_capacity, n)
    colors_u8, depths_u16, inv_q_t = (colors_u8[lo:hi], depths_u16[lo:hi],
                                      inv_q_t[lo:hi])
    rows = hi - lo
    with torch.no_grad():
        if store.mode != "device":
            for buf, src in zip(store.wire(), (colors_u8, depths_u16,
                                               inv_q_t)):
                buf[:rows].copy_(src)
        elif rows:
            # The mapper's own conversion, so colors come back bit for bit.
            colors = colors_u8.to(dev).to(torch.float32) * (1.0 / 255.0)
            store.colors[:rows] = colors.to(store.colors.dtype)
            depths = (depths_u16.to(torch.float32)
                      * inv_q_t[:, None, None])
            store.depths[:rows] = depths.to(dev)
        store.est_c2w[:n] = torch.from_numpy(data["kf_est_c2w"]).to(dev)
        store.gt_c2w[:n] = torch.from_numpy(data["kf_gt_c2w"]).to(dev)
    store.count = n
    store.frame_ids = [int(i) for i in frame_ids]
    store.has_depthless[:n] = [bool(b) for b in data["kf_has_depthless"]]
    slam.draws.generator.set_state(
        torch.from_numpy(data["draws_generator_state"]))
    return int(data["idx"]) + 1


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The newest complete checkpoint in ``ckpt_dir`` (names sort by
    frame); interrupted writes (``*.tmp.npz``) are ignored."""
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = sorted(f for f in os.listdir(ckpt_dir)
                   if f.endswith(".npz") and not f.endswith(".tmp.npz"))
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None
