#!/usr/bin/env python
"""Frustum (+ occlusion) mesh culling before reconstruction eval.

The port of ``myslam_tpu/tools/cull_mesh.py`` (reference
src/tools/cull_mesh.py:36-114): a mesh vertex survives if some frame
sees it — inside the image bounds, in front of the camera, and (eval_rec
mode) not occluded beyond the observed depth + truncation.  Faces whose
three vertices are never seen are removed.  The projection and depth
test run on the given device, 16 frames per step, OR-reduced there;
frames stream through a prefetch thread.

Quirks kept: raw (un-cropped) cfg intrinsics are used for projection
while depth maps are the preprocessed ones, and the depth lookup uses
grid_sample-style normalization u*(W-1)/W with zero padding.

CLI: python -m myslam_torch.tools.cull_mesh <config> --input_mesh mesh.ply
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from myslam_torch import resolve_device
from myslam_torch.utils.ply import read_ply, write_ply


def _bilinear_zeros(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """grid_sample(bilinear, zeros padding, align_corners=True) lookup of
    img (..., H, W) at x, y (..., N) in pixel units of the align_corners
    grid (the leading dimensions batch frames)."""
    H, W = img.shape[-2:]
    flat = img.reshape(img.shape[:-2] + (H * W,))
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi_c = torch.clamp(xi, 0, W - 1).to(torch.int64)
        yi_c = torch.clamp(yi, 0, H - 1).to(torch.int64)
        val = torch.gather(flat, -1, yi_c * W + xi_c)
        return torch.where(inb, val, 0.0)

    return ((1 - wy) * (1 - wx) * tap(x0, y0)
            + (1 - wy) * wx * tap(x0 + 1, y0)
            + wy * (1 - wx) * tap(x0, y0 + 1)
            + wy * wx * tap(x0 + 1, y0 + 1))


def _w2c(c2w: np.ndarray) -> np.ndarray:
    """Rigid inverses (B, 4, 4) float32, on the host."""
    c2w = np.asarray(c2w, np.float32)
    Rt = np.swapaxes(c2w[:, :3, :3], -1, -2)
    out = np.zeros_like(c2w)
    out[:, :3, :3] = Rt
    out[:, :3, 3] = -np.einsum("bij,bj->bi", Rt, c2w[:, :3, 3])
    out[:, 3, 3] = 1.0
    return out


def _project(verts: torch.Tensor, w2c: torch.Tensor, fx, fy, cx, cy):
    """``core.geometry.project_points`` of verts (N, 3) into B cameras
    w2c (B, 4, 4), each (B, N), in elementwise operations only, so that
    the card and the CPU round alike."""
    R = w2c[:, None, :3, :3]
    t = w2c[:, None, :3, 3]
    p = verts[None]
    x, y, z = (R[..., k, 0] * p[..., 0] + R[..., k, 1] * p[..., 1]
               + R[..., k, 2] * p[..., 2] + t[..., k] for k in range(3))
    zs = z + 1e-5
    return (fx * -x + cx * z) / zs, (fy * y + cy * z) / zs, z


def make_batch_culler(H, W, fx, fy, cx, cy, truncation, eval_rec: bool):
    """seen_any(verts (N, 3), depths (B, Hd, Wd), w2cs (B, 4, 4)) ->
    (N,) bool: whether any of the B frames sees each vertex."""

    def seen_any(verts, depths, w2cs):
        u, v, z = _project(verts, w2cs, fx, fy, cx, cy)  # (B, N)
        Hd, Wd = depths.shape[-2:]
        ds = _bilinear_zeros(depths, u * (Wd - 1) / W, v * (Hd - 1) / H)
        mask = (0 <= -z) & (u < W) & (u > 0) & (v < H) & (v > 0)
        if eval_rec:
            mask = mask & (ds + truncation >= -z)
        return mask.any(dim=0)

    return seen_any


def vertex_visibility(verts: np.ndarray, cfg: dict, frames,
                      estimate_c2w_list: np.ndarray | None = None,
                      frames_per_program: int = 16,
                      device=None) -> np.ndarray:
    """(N,) bool: is each vertex seen by at least one frame (frustum +
    eval_rec occlusion test)?  The core of cull_mesh, also used to derive
    the GT 'unseen' point set for the 2-D depth-L1 protocol.  Runs on
    ``device`` (default: the GPU); ``frames_per_program`` frames per
    step, the result does not depend on it."""
    dev = resolve_device(device)
    cam = cfg["cam"]
    verts_d = torch.as_tensor(np.asarray(verts, np.float32)).to(dev)
    seen_fn = make_batch_culler(
        cam["H"], cam["W"], cam["fx"], cam["fy"], cam["cx"], cam["cy"],
        cfg["model"]["truncation"], bool(cfg["meshing"]["eval_rec"]))
    ever = torch.zeros((len(verts_d),), dtype=torch.bool, device=dev)
    batch: list = []

    def flush(batch):
        depths = torch.as_tensor(np.stack([d for d, _ in batch])).to(dev)
        w2cs = torch.as_tensor(_w2c(np.stack([p for _, p in batch])))
        return ever | seen_fn(verts_d, depths, w2cs.to(dev))

    for i, (depth, c2w) in enumerate(frames):
        if estimate_c2w_list is not None:
            c2w = estimate_c2w_list[i]
        batch.append((np.asarray(depth, np.float32),
                      np.asarray(c2w, np.float32)))
        if len(batch) == frames_per_program:
            ever = flush(batch)
            batch = []
    if batch:
        ever = flush(batch)
    return ever.cpu().numpy()


def cull_mesh(mesh_file: str, cfg: dict, frames, out_file: str | None = None,
              estimate_c2w_list: np.ndarray | None = None,
              frames_per_program: int = 16, device=None) -> str:
    """frames: iterable of (depth (H,W) np, c2w (4,4) np) per frame."""
    verts, faces, colors = read_ply(mesh_file)
    ever = vertex_visibility(verts, cfg, frames, estimate_c2w_list,
                             frames_per_program, device)
    keep_face = ever[faces].any(axis=1)  # drop faces with all-unseen verts
    faces = faces[keep_face]

    # drop unreferenced vertices, remap indices
    used = np.zeros(len(verts), bool)
    used[faces.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    verts = verts[used]
    colors = colors[used] if colors is not None else None
    faces = remap[faces]

    if out_file is None:
        ext = mesh_file.split(".")[-1]
        out_file = mesh_file[: -len(ext) - 1] + "_culled." + ext
    write_ply(out_file, verts, faces,
              colors.astype(np.float32) / 255.0 if colors is not None else None)
    return out_file


def main(argv=None):
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config
    from myslam_torch.utils.datasets import Prefetcher, get_dataset

    parser = argparse.ArgumentParser(description="Cull a mesh with GT poses.")
    parser.add_argument("config", type=str)
    parser.add_argument("--input_mesh", type=str, required=True)
    parser.add_argument("--input_folder", type=str, default=None)
    parser.add_argument("--output_mesh", type=str, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, DEFAULT_CONFIG)
    dataset = get_dataset(cfg, args.input_folder)
    frames = ((d, p) for _, (c, d, p) in
              Prefetcher(dataset, range(len(dataset))))
    out = cull_mesh(args.input_mesh, cfg, frames, args.output_mesh,
                    device=args.device)
    print(f"Culled mesh written to {out}")


if __name__ == "__main__":
    main()
