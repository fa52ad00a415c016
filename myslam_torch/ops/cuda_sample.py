"""Tri-plane sample kernels K1 (forward) and K2 (backward), their plain
PyTorch versions, and the build of every kernel of the port.

The kernels live in ``myslam_torch/csrc/``: CUDA C++ for ``sm_90a`` with
a plain C interface, compiled with nvcc at first use into one shared
library in ``build/kernels/`` (keyed by a hash of every source, the
shared headers and the flags; the sources are compiled in parallel,
then linked) and bound with ctypes.  ``plane_sample.cu`` holds K1, the
Hopper counterpart of ``myslam_tpu/ops/pallas_sample.py``'s B1/B3
forward, and K2, that of the hand-written VJP
``myslam_tpu/ops/plane_sample.py::_sample_fused_bwd``;
``plane_sample_smem.cu`` holds K3 (``ops/smem_sample.py``).  K1 and K2
also come banded (``plane_sample_fwd_banded``, ``plane_sample_bwd_banded``)
over one map shard's band atlas (a ``BandLayout``,
``parallel/plane_shard.py``), where a point outside a plane's band reads
nothing and scatters nothing: banded K1 is K1's walk, banded K2 compacts
each chunk of points to those the band owns and walks only those
(``band_lists`` mirrors its lists).

Dispatch is by the tensors' device and nothing else: a CPU tensor takes
the plain version below, a CUDA tensor launches the kernel or raises.
There is no fallback from a CUDA tensor to the plain version.

Every launch adds one to ``LAUNCHES[name]``.  The one other writer is
the tracker's replayed iteration (``engine/tracker.py``): a replay of its
CUDA graph adds the launches the capture recorded, and the capture takes
its own back, so the counter counts every run on the device.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

from myslam_torch.models.planes import BandLayout, PlaneLayout

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

LAUNCHES = {"plane_sample_fwd": 0, "plane_sample_bwd": 0,
            "plane_sample_fwd_smem": 0, "plane_sample_fwd_banded": 0,
            "plane_sample_bwd_banded": 0}

# K1's launch: each warp walks one run of FWD_RUN consecutive points (at
# most a tile of 32), loading a plane's row only where it differs from the
# point before's (chosen on the card among 4, 8, 16 and 32, PERF.md);
# FWD_WARPS is the kernel's compile-time block (plane_sample.cu).
FWD_RUN = 8
FWD_WARPS = 8
# K2's launch: each warp walks BWD_RUN consecutive points, merging the
# quad-gradient updates of points that share a row (chosen on the card
# among 8, 16 and 40 points, PERF.md); BWD_WARPS is the kernel's
# compile-time block (plane_sample.cu).
BWD_RUN = 16
BWD_WARPS = 8
# Banded K2's launch: each block compacts a chunk of BWD_BANDED_CHUNK
# consecutive points (one per thread of its BWD_BANDED_WARPS warps) to
# those with an owned level, and its warps walk that list; both are the
# kernel's compile-time constants (plane_sample.cu).
BWD_BANDED_WARPS = 4
BWD_BANDED_CHUNK = 32 * BWD_BANDED_WARPS

_lib = None
BUILD_LOG = ""
# Seconds this process spent compiling kernels (0 when the library was
# already built).
BUILD_SECONDS = 0.0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain versions (the CPU path and the kernels' oracle) ---------------

_sign_cache: dict = {}


def lane_signs(c_dim: int, device):
    """(4C,) corner sign vectors sx, sy of the quad row [tl | tr | bl | br]:
    sx = +1 on the right corners, sy = +1 on the bottom corners."""
    key = (c_dim, str(device))
    if key not in _sign_cache:
        lane = torch.arange(4 * c_dim)
        sx = torch.where((lane // c_dim) % 2 == 1, 1.0, -1.0)
        sy = torch.where(lane >= 2 * c_dim, 1.0, -1.0)
        _sign_cache[key] = (sx.to(device), sy.to(device))
    return _sign_cache[key]


def plane_coords(p_nor: torch.Tensor, au: int, av: int, H: int, W: int):
    """Per-plane cell index, bilinear fractions and in-range masks, each
    (N,): grid_sample align_corners=True with border padding."""
    u = p_nor[:, au]
    v = p_nor[:, av]
    xr = (u + 1.0) * 0.5 * (W - 1.0)
    yr = (v + 1.0) * 0.5 * (H - 1.0)
    x = torch.clamp(xr, 0.0, W - 1.0)
    y = torch.clamp(yr, 0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    cell = (y0 * W + x0).long()
    in_x = ((xr >= 0.0) & (xr <= W - 1.0)).to(torch.float32)
    in_y = ((yr >= 0.0) & (yr <= H - 1.0)).to(torch.float32)
    return cell, x - x0, y - y0, in_x, in_y


def plane_sample_fwd_ref(quad: torch.Tensor, layout: PlaneLayout,
                         p_nor: torch.Tensor) -> torch.Tensor:
    """Weighted, orientation-summed corner features (N, L*4C) float32.

    Per plane, one quad-atlas row per point weighted in lane space by
    (0.5 + (wx-0.5) sx)(0.5 + (wy-0.5) sy); weighting in f32 whatever
    the quad's dtype.
    """
    sx, sy = lane_signs(layout.c_dim, quad.device)
    reds = []
    for lvl, ori, au, av, H, W, off in layout.planes():
        cell, wx, wy, _, _ = plane_coords(p_nor, au, av, H, W)
        g = quad.index_select(0, off + cell)
        w = (0.5 + (wx[:, None] - 0.5) * sx) * (0.5 + (wy[:, None] - 0.5)
                                                * sy)
        term = g.to(torch.float32) * w
        if ori == 0:
            reds.append(term)
        else:
            reds[lvl] = reds[lvl] + term
    return torch.cat(reds, dim=-1)


def plane_sample_bwd_ref(gbar: torch.Tensor, quad: torch.Tensor,
                         layout: PlaneLayout, p_nor: torch.Tensor,
                         need_quad_grad: bool = True):
    """Backward of plane_sample_fwd_ref: (quad_grad (S, 4C) f32 or None,
    p_grad (N, 3) f32).

    The quad gradient scatter-adds gbar*fx*fy into each plane's rows;
    the coordinate gradient is sum_lanes(g*gbar*sx*fy) (and its dual),
    masked to zero where the border clamp is active and scaled by the
    plane's half extent.
    """
    n = gbar.shape[0]
    C4 = 4 * layout.c_dim
    sx, sy = lane_signs(layout.c_dim, quad.device)
    quad_grad = (torch.zeros((layout.total_rows, C4), dtype=torch.float32,
                             device=quad.device)
                 if need_quad_grad else None)
    pg = [torch.zeros((n,), dtype=torch.float32, device=quad.device)
          for _ in range(3)]
    for lvl, ori, au, av, H, W, off in layout.planes():
        cell, wx, wy, in_x, in_y = plane_coords(p_nor, au, av, H, W)
        gl = gbar[:, lvl * C4:(lvl + 1) * C4]
        fx = 0.5 + (wx[:, None] - 0.5) * sx
        fy = 0.5 + (wy[:, None] - 0.5) * sy
        if need_quad_grad:
            quad_grad.index_add_(0, off + cell, gl * (fx * fy))
        ggl = quad.index_select(0, off + cell).to(torch.float32) * gl
        dwx = (ggl * (sx * fy)).sum(-1)
        dwy = (ggl * (sy * fx)).sum(-1)
        pg[au] = pg[au] + dwx * in_x * (0.5 * (W - 1.0))
        pg[av] = pg[av] + dwy * in_y * (0.5 * (H - 1.0))
    return quad_grad, torch.stack(pg, dim=-1)


def band_coords(p_nor: torch.Tensor, au: int, av: int, H: int, W: int,
                off: int, y_lo: int, band_h: int, rows: int):
    """plane_coords on one plane's band: the band atlas row of each
    point's cell (clamped into the atlas where the point is not owned),
    whether its cell row lies in [y_lo, y_lo + band_h), the fractions and
    the in-range masks (the index math of the JAX package's
    ``sample_local``)."""
    cell, wx, wy, in_x, in_y = plane_coords(p_nor, au, av, H, W)
    yi = torch.div(cell, W, rounding_mode="floor")
    owned = (yi >= y_lo) & (yi < y_lo + band_h)
    row = torch.clamp(off + (yi - y_lo) * W + (cell - yi * W), 0, rows - 1)
    return row, owned, wx, wy, in_x, in_y


def band_lists(band: BandLayout, p_nor: torch.Tensor,
               chunk: int = BWD_BANDED_CHUNK):
    """The lists banded K2 builds and walks, computed as the kernel does:
    block b takes points [b*chunk, (b+1)*chunk), one per thread; a warp's
    ballot of the points with an owned level, its popcount and the scan
    of the warps' counts place each such point in the block's list, in
    point order.  Returns (points (blocks, chunk) int64, -1 past a
    block's length; their level masks, 0 there; lengths (blocks,))."""
    n = p_nor.shape[0]
    blocks = -(-n // chunk)
    # Bit l: the point owns a plane of level l (its cell row is in that
    # plane's band).
    mask = torch.zeros(blocks * chunk, dtype=torch.int64)
    for lvl, _, au, av, H, W, off, y_lo, bh in band.planes():
        owned = band_coords(p_nor, au, av, H, W, off, y_lo, bh,
                            band.total_rows)[1]
        mask[:n] |= owned.cpu().to(torch.int64) << lvl
    flag = (mask != 0).view(blocks, chunk // 32, 32).to(torch.int64)
    counts = flag.sum(-1)  # popcount of each warp's ballot
    warp_off = torch.cumsum(counts, -1) - counts
    pos = (warp_off[..., None] + torch.cumsum(flag, -1) - flag).view(
        blocks, chunk)
    lengths = counts.sum(-1)
    points = torch.full((blocks, chunk), -1, dtype=torch.int64)
    masks = torch.zeros((blocks, chunk), dtype=torch.int64)
    b, t = torch.nonzero(flag.view(blocks, chunk), as_tuple=True)
    points[b, pos[b, t]] = b * chunk + t
    masks[b, pos[b, t]] = mask[b * chunk + t]
    return points, masks, lengths


def plane_sample_fwd_banded_ref(quad: torch.Tensor, band: BandLayout,
                                p_nor: torch.Tensor) -> torch.Tensor:
    """The forward over a band atlas (``band.total_rows`` rows), (N,
    L*4C) float32: each plane's term where the point's cell row is in
    the band, zero elsewhere.  Summed over the shards it is the
    unbanded forward."""
    sx, sy = lane_signs(band.c_dim, quad.device)
    reds = []
    for lvl, ori, au, av, H, W, off, y_lo, bh in band.planes():
        row, owned, wx, wy, _, _ = band_coords(p_nor, au, av, H, W, off,
                                               y_lo, bh, band.total_rows)
        g = quad.index_select(0, row).to(torch.float32)
        g = torch.where(owned[:, None], g, torch.zeros_like(g))
        w = (0.5 + (wx[:, None] - 0.5) * sx) * (0.5 + (wy[:, None] - 0.5)
                                                * sy)
        term = g * w
        if ori == 0:
            reds.append(term)
        else:
            reds[lvl] = reds[lvl] + term
    return torch.cat(reds, dim=-1)


def plane_sample_bwd_banded_ref(gbar: torch.Tensor, quad: torch.Tensor,
                                band: BandLayout, p_nor: torch.Tensor,
                                need_quad_grad: bool = True):
    """Backward of plane_sample_fwd_banded_ref: (quad_grad (band rows,
    4C) f32 or None, p_grad (N, 3) f32), the owned points' terms
    alone."""
    n = gbar.shape[0]
    C4 = 4 * band.c_dim
    sx, sy = lane_signs(band.c_dim, quad.device)
    quad_grad = (torch.zeros((band.total_rows, C4), dtype=torch.float32,
                             device=quad.device)
                 if need_quad_grad else None)
    pg = [torch.zeros((n,), dtype=torch.float32, device=quad.device)
          for _ in range(3)]
    for lvl, ori, au, av, H, W, off, y_lo, bh in band.planes():
        row, owned, wx, wy, in_x, in_y = band_coords(
            p_nor, au, av, H, W, off, y_lo, bh, band.total_rows)
        gl = gbar[:, lvl * C4:(lvl + 1) * C4]
        gl = torch.where(owned[:, None], gl, torch.zeros_like(gl))
        fx = 0.5 + (wx[:, None] - 0.5) * sx
        fy = 0.5 + (wy[:, None] - 0.5) * sy
        if need_quad_grad:
            quad_grad.index_add_(0, row[owned], (gl * (fx * fy))[owned])
        ggl = quad.index_select(0, row).to(torch.float32) * gl
        dwx = (ggl * (sx * fy)).sum(-1)
        dwy = (ggl * (sy * fx)).sum(-1)
        pg[au] = pg[au] + dwx * in_x * (0.5 * (W - 1.0))
        pg[av] = pg[av] + dwy * in_y * (0.5 * (H - 1.0))
    return quad_grad, torch.stack(pg, dim=-1)


# -- the CUDA library ----------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


def library_path() -> str:
    """The kernels' library, named by a hash of every csrc source and
    header and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"kernels_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels' library unless it exists, and return its
    path: one ``nvcc -c`` per csrc/*.cu, all started together, then one
    link.  nvcc's register/spill report lands in BUILD_LOG, the wall
    time in BUILD_SECONDS."""
    global BUILD_LOG, BUILD_SECONDS
    path = library_path()
    if os.path.exists(path):
        return path
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = []
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _, proc in objs:
        log, _ = proc.communicate(timeout=600)
        BUILD_LOG += f"== {os.path.basename(src)}\n{log}"
        if proc.returncode:
            failed.append(os.path.basename(src))
    if not failed:
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", tmp,
             *(obj for _, obj, _ in objs)],
            capture_output=True, text=True, timeout=600)
        BUILD_LOG += f"== link\n{link.stdout}{link.stderr}"
        if link.returncode:
            failed.append("link")
    for _, obj, _ in objs:
        if os.path.exists(obj):
            os.remove(obj)
    BUILD_SECONDS += time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{BUILD_LOG}")
    os.replace(tmp, path)
    return path


def load():
    """The kernels' ctypes library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.plane_sample_fwd.argtypes = [vp, vp, ci, vp, ci, ci, ci, vp, ci,
                                         ci, ci, vp]
        lib.plane_sample_fwd.restype = ci
        lib.plane_sample_bwd.argtypes = [vp, vp, vp, ci, vp, vp, ci, ci, ci,
                                         vp, ci, ci, ci, vp]
        lib.plane_sample_bwd.restype = ci
        lib.plane_sample_fwd_smem.argtypes = [vp, vp, ci, vp, ci, ci, ci, vp,
                                              ci, ci, ci, ci, vp, vp]
        lib.plane_sample_fwd_smem.restype = ci
        lib.plane_sample_fwd_banded.argtypes = [vp, vp, ci, vp, ci, ci, ci,
                                                vp, vp, ci, ci, ci, vp]
        lib.plane_sample_fwd_banded.restype = ci
        lib.plane_sample_bwd_banded.argtypes = [vp, vp, vp, ci, vp, vp, ci,
                                                ci, ci, vp, vp, ci, ci, ci,
                                                vp]
        lib.plane_sample_bwd_banded.restype = ci
        _lib = lib
    return _lib


_table_cache: dict = {}


def _plane_table(layout: PlaneLayout):
    """(H, W, offset, u-axis, v-axis) per plane as a host int array."""
    if layout not in _table_cache:
        vals = []
        for _, _, au, av, H, W, off in layout.planes():
            vals += [H, W, off, au, av]
        _table_cache[layout] = (ctypes.c_int * len(vals))(*vals)
    return _table_cache[layout]


def _band_tables(band: BandLayout):
    """A band layout's plane table (H, W, band offset, u-axis, v-axis)
    and band table (y_lo, band_h) per plane, as host int arrays."""
    if band not in _table_cache:
        planes, bands = [], []
        for _, _, au, av, H, W, off, y_lo, bh in band.planes():
            planes += [H, W, off, au, av]
            bands += [y_lo, bh]
        _table_cache[band] = ((ctypes.c_int * len(planes))(*planes),
                              (ctypes.c_int * len(bands))(*bands))
    return _table_cache[band]


def _check(t: torch.Tensor, name: str, dtypes, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, kernel takes {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_common(quad, layout, p_nor):
    if p_nor.device.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got "
                         f"{p_nor.device}")
    if layout.c_dim % 4:
        raise ValueError("kernel needs c_dim divisible by 4")
    if 3 * layout.n_levels > 12:
        raise ValueError("kernel takes at most 4 levels")
    dev = p_nor.device
    _check(p_nor, "p_nor", (torch.float32,), (p_nor.shape[0], 3), dev)
    _check(quad, "quad", (torch.float32, torch.bfloat16),
           (layout.total_rows, 4 * layout.c_dim), dev)


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def fwd_launch_plan(n: int) -> tuple[int, int, int]:
    """K1's launch for n > 0 points: (points per run, warps per block,
    blocks).  Warp w of the grid walks run w, points [w*run, min((w+1)*run,
    n)), so the plan covers every point once and leaves no block empty."""
    runs = -(-n // FWD_RUN)
    return FWD_RUN, FWD_WARPS, -(-runs // FWD_WARPS)


def bwd_launch_plan(n: int) -> tuple[int, int, int]:
    """K2's launch for n > 0 points: (points per warp, warps per block,
    blocks).  Warp w of the grid walks points [w*run, min((w+1)*run, n)),
    so the plan covers every point once and leaves no block empty."""
    warps = -(-n // BWD_RUN)
    return BWD_RUN, BWD_WARPS, -(-warps // BWD_WARPS)


def bwd_banded_launch_plan(n: int) -> tuple[int, int, int]:
    """Banded K2's launch for n > 0 points: (points per block, warps per
    block, blocks).  Block b compacts points [b*chunk, min((b+1)*chunk,
    n)), so the plan covers every point once and leaves no block
    empty."""
    return BWD_BANDED_CHUNK, BWD_BANDED_WARPS, -(-n // BWD_BANDED_CHUNK)


def plane_sample_fwd(quad: torch.Tensor, layout: PlaneLayout,
                     p_nor: torch.Tensor) -> torch.Tensor:
    """Tri-plane sample forward, (N, L*4C) float32.  CPU tensors: the
    plain version; CUDA tensors: kernel K1 (runs of consecutive points
    per warp that reuse the rows they share; ``fwd_launch_plan``)."""
    if p_nor.device.type == "cpu" and quad.device.type == "cpu":
        return plane_sample_fwd_ref(quad, layout, p_nor)
    _check_common(quad, layout, p_nor)
    n = p_nor.shape[0]
    C4 = 4 * layout.c_dim
    out = torch.empty((n, layout.n_levels * C4), dtype=torch.float32,
                      device=p_nor.device)
    if n == 0:
        return out
    lib = load()
    run, warps, blocks = fwd_launch_plan(n)
    err = lib.plane_sample_fwd(
        p_nor.data_ptr(), quad.data_ptr(), int(quad.dtype == torch.bfloat16),
        out.data_ptr(), n, C4, layout.n_levels,
        ctypes.cast(_plane_table(layout), ctypes.c_void_p), run, warps,
        blocks, torch.cuda.current_stream(p_nor.device).cuda_stream)
    _raise_on(err, "plane_sample_fwd")
    LAUNCHES["plane_sample_fwd"] += 1
    return out


def plane_sample_bwd(gbar: torch.Tensor, quad: torch.Tensor,
                     layout: PlaneLayout, p_nor: torch.Tensor,
                     need_quad_grad: bool = True):
    """Tri-plane sample backward: (quad_grad (S, 4C) f32 or None, p_grad
    (N, 3) f32).  CPU tensors: the plain version; CUDA tensors: kernel
    K2 (the quad gradient, only when asked for, by vector atomics of
    runs merged in registers; ``bwd_launch_plan``)."""
    if p_nor.device.type == "cpu" and quad.device.type == "cpu":
        return plane_sample_bwd_ref(gbar, quad, layout, p_nor,
                                    need_quad_grad)
    _check_common(quad, layout, p_nor)
    n = p_nor.shape[0]
    C4 = 4 * layout.c_dim
    _check(gbar, "gbar", (torch.float32,), (n, layout.n_levels * C4),
           p_nor.device)
    quad_grad = (torch.zeros((layout.total_rows, C4), dtype=torch.float32,
                             device=p_nor.device)
                 if need_quad_grad else None)
    p_grad = torch.empty((n, 3), dtype=torch.float32, device=p_nor.device)
    if n == 0:
        return quad_grad, p_grad
    lib = load()
    run, warps, blocks = bwd_launch_plan(n)
    err = lib.plane_sample_bwd(
        gbar.data_ptr(), p_nor.data_ptr(), quad.data_ptr(),
        int(quad.dtype == torch.bfloat16),
        quad_grad.data_ptr() if need_quad_grad else None,
        p_grad.data_ptr(), n, C4, layout.n_levels,
        ctypes.cast(_plane_table(layout), ctypes.c_void_p), run, warps,
        blocks, torch.cuda.current_stream(p_nor.device).cuda_stream)
    _raise_on(err, "plane_sample_bwd")
    LAUNCHES["plane_sample_bwd"] += 1
    return quad_grad, p_grad


def plane_sample_fwd_banded(quad: torch.Tensor, band: BandLayout,
                            p_nor: torch.Tensor) -> torch.Tensor:
    """The forward over one shard's band atlas, (N, L*4C) float32: the
    owned points' terms (``plane_sample_fwd_banded_ref``).  CPU tensors:
    the plain version; CUDA tensors: banded kernel K1 (the same launch
    plan as K1)."""
    if p_nor.device.type == "cpu" and quad.device.type == "cpu":
        return plane_sample_fwd_banded_ref(quad, band, p_nor)
    _check_common(quad, band, p_nor)
    n = p_nor.shape[0]
    C4 = 4 * band.c_dim
    out = torch.empty((n, band.n_levels * C4), dtype=torch.float32,
                      device=p_nor.device)
    if n == 0:
        return out
    lib = load()
    planes, bands = _band_tables(band)
    run, warps, blocks = fwd_launch_plan(n)
    err = lib.plane_sample_fwd_banded(
        p_nor.data_ptr(), quad.data_ptr(), int(quad.dtype == torch.bfloat16),
        out.data_ptr(), n, C4, band.n_levels,
        ctypes.cast(planes, ctypes.c_void_p),
        ctypes.cast(bands, ctypes.c_void_p), run, warps, blocks,
        torch.cuda.current_stream(p_nor.device).cuda_stream)
    _raise_on(err, "plane_sample_fwd_banded")
    LAUNCHES["plane_sample_fwd_banded"] += 1
    return out


def plane_sample_bwd_banded(gbar: torch.Tensor, quad: torch.Tensor,
                            band: BandLayout, p_nor: torch.Tensor,
                            need_quad_grad: bool = True):
    """Backward over one shard's band atlas: (quad_grad (band rows, 4C)
    f32 or None, p_grad (N, 3) f32, this shard's part of the coordinate
    gradient).  CPU tensors: the plain version; CUDA tensors: banded
    kernel K2 (each block walks the points of its chunk that own a level
    of the band; ``bwd_banded_launch_plan``, ``band_lists``)."""
    if p_nor.device.type == "cpu" and quad.device.type == "cpu":
        return plane_sample_bwd_banded_ref(gbar, quad, band, p_nor,
                                           need_quad_grad)
    _check_common(quad, band, p_nor)
    n = p_nor.shape[0]
    C4 = 4 * band.c_dim
    _check(gbar, "gbar", (torch.float32,), (n, band.n_levels * C4),
           p_nor.device)
    quad_grad = (torch.zeros((band.total_rows, C4), dtype=torch.float32,
                             device=p_nor.device)
                 if need_quad_grad else None)
    p_grad = torch.empty((n, 3), dtype=torch.float32, device=p_nor.device)
    if n == 0:
        return quad_grad, p_grad
    lib = load()
    planes, bands = _band_tables(band)
    chunk, warps, blocks = bwd_banded_launch_plan(n)
    err = lib.plane_sample_bwd_banded(
        gbar.data_ptr(), p_nor.data_ptr(), quad.data_ptr(),
        int(quad.dtype == torch.bfloat16),
        quad_grad.data_ptr() if need_quad_grad else None,
        p_grad.data_ptr(), n, C4, band.n_levels,
        ctypes.cast(planes, ctypes.c_void_p),
        ctypes.cast(bands, ctypes.c_void_p), chunk, warps, blocks,
        torch.cuda.current_stream(p_nor.device).cuda_stream)
    _raise_on(err, "plane_sample_bwd_banded")
    LAUNCHES["plane_sample_bwd_banded"] += 1
    return quad_grad, p_grad
