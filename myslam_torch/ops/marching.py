"""Isosurface extraction (marching tetrahedra) on the volume's device.

The port of ``myslam_tpu/ops/marching.py``, in PyTorch operations, slab
by slab over x:

  1. EXTRACT: per slab, the active tets' crossing edges become triangle
     slots, each with its edge's identity as one int64 key,
     ``node_id * 8 + direction code``, and its interpolated position.
     The slabs' slots are concatenated, so the buffers are exactly sized
     (JAX rounds them up to capacity buckets for XLA's static shapes;
     eager PyTorch needs none).
  2. WELD: a stable sort of the keys; a vertex per distinct key, in
     ascending key order (as JAX's), placed at the position of the run's
     first slot in the sorted order.  Slots that share an edge may hold
     positions one ulp apart (the tets sharing it see its ends in
     swapped order, ``_EDGE_SWAP``); taking the first of the stable order
     makes the card and the CPU agree bit for bit, where a scatter with
     duplicate indices would keep an arbitrary one.  The welded vertices
     are checked against the count of sign-crossing grid edges.

Marching tetrahedra: the 6-tet decomposition around the main diagonal is
conforming across cells, so every vertex lies on one grid edge and the
weld by edge identity is exact (no floating-point quantization).
"""

from __future__ import annotations

import numpy as np
import torch

# Cube corners in binary (x, y, z) bit order; main diagonal 0-7.
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
    [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int64)

# 6-tetrahedra decomposition around the 0-7 diagonal.  All face-diagonal
# edges pass through corner 0 or corner 7, so the decomposition is
# conforming across neighboring cells (shared faces use the same
# diagonal) — which makes edge-identity vertex welding exact.
_TETS = np.array([
    [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
    [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], np.int64)

_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)


def _build_tet_table() -> np.ndarray:
    """(16, 6) triangle table: up to 2 triangles as edge ids, -1 padded."""
    def eid(a, b):
        return int(np.where(
            (_TET_EDGES == sorted((a, b))).all(axis=1))[0][0])

    table = -np.ones((16, 6), np.int64)
    for case in range(1, 15):
        inside = [i for i in range(4) if case >> i & 1]
        outside = [i for i in range(4) if not case >> i & 1]
        if len(inside) == 1:
            v = inside[0]
            table[case, :3] = [eid(v, o) for o in outside]
        elif len(inside) == 3:
            v = outside[0]
            table[case, :3] = [eid(v, o) for o in inside]
        else:  # 2-2: quad on 4 crossing edges, cyclic, split into 2 tris
            a, b = inside
            c, d = outside
            q = [eid(a, c), eid(a, d), eid(b, d), eid(b, c)]
            table[case, :3] = [q[0], q[1], q[2]]
            table[case, 3:] = [q[0], q[2], q[3]]
    return table


_TET_TABLE = _build_tet_table()


def _build_edge_tables():
    """Canonical (low-node offset, direction code, swapped) per (tet, edge).

    A tet edge connects two cube corners whose offset delta is
    single-signed for this decomposition (asserted), so canonicalizing to
    a non-negative delta gives every geometric grid edge ONE identity:
    (low node, direction code in 1..7).  That identity is the weld key.
    """
    lo = np.zeros((6, 6, 3), np.int64)
    code = np.zeros((6, 6), np.int64)
    swap = np.zeros((6, 6), bool)
    for t in range(6):
        for e in range(6):
            ca = _TETS[t][_TET_EDGES[e][0]]
            cb = _TETS[t][_TET_EDGES[e][1]]
            oa, ob = _CORNERS[ca], _CORNERS[cb]
            d = ob - oa
            assert (d >= 0).all() or (d <= 0).all(), (t, e, d)
            if (d < 0).any():
                oa, ob = ob, oa
                d = -d
                swap[t, e] = True
            lo[t, e] = oa
            code[t, e] = d[0] * 4 + d[1] * 2 + d[2]
    return lo, code, swap


_EDGE_LO, _EDGE_CODE, _EDGE_SWAP = _build_edge_tables()
# direction code -> (dx, dy, dz)
_DIR_VEC = np.stack([np.array([c >> 2 & 1, c >> 1 & 1, c & 1], np.int64)
                     for c in range(8)])

_table_cache: dict = {}


def _tables(device) -> dict:
    key = str(device)
    if key not in _table_cache:
        _table_cache[key] = {
            name: torch.as_tensor(a).to(device) for name, a in (
                ("tets", _TETS.reshape(-1)), ("ea", _TET_EDGES[:, 0]),
                ("eb", _TET_EDGES[:, 1]), ("edge_lo", _EDGE_LO),
                ("edge_code", _EDGE_CODE), ("edge_swap", _EDGE_SWAP),
                ("dir_vec", _DIR_VEC.astype(np.float32)),
                ("tet_table", _TET_TABLE))}
    return _table_cache[key]


def slab_x_cells(shape, slab_cells: int) -> int:
    """x-cells per slab: as many whole x-layers of cells as fit in
    ``slab_cells``, at least one (the JAX package's rule)."""
    nx, ny, nz = shape
    per_x = max((ny - 1) * (nz - 1), 1)
    return max(min(slab_cells // per_x, nx - 1), 1)


def _slab_cases(vol: torch.Tensor, x0: int, sx: int, level: float, tab):
    """Corner values (6, 4, cells) and per-tet case codes (6, cells) for
    the cells [x0, x0 + sx) (x-major, then y, then z)."""
    _, ny, nz = vol.shape
    cy, cz = ny - 1, nz - 1
    sl = vol[x0:x0 + sx + 1]
    corners = torch.stack([
        sl[bx:bx + sx, by:by + cy, bz:bz + cz]
        for bx, by, bz in _CORNERS.tolist()], dim=0)  # (8, sx, cy, cz)
    vals = corners.reshape(8, -1)
    tet_vals = vals[tab["tets"]].reshape(6, 4, -1)
    inside = (tet_vals < level).to(torch.int64)
    case = (inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2]
            + 8 * inside[:, 3])  # (6, cells)
    return tet_vals, case


def _slabs(nx: int, sx: int):
    """(x0, cells along x) of each slab; the last may be thinner."""
    return [(x0, min(sx, nx - 1 - x0)) for x0 in range(0, nx - 1, sx)]


def crossing_edges(vol: torch.Tensor, level: float) -> torch.Tensor:
    """Sign-crossing grid edges over the 7 within-cell directions (a
    device scalar): the 6-tet decomposition uses every cube edge, one
    diagonal per face (consistent across neighbors), and the main
    diagonal, so each crossing edge yields exactly one welded vertex."""
    nx, ny, nz = vol.shape
    sign = vol < level
    n_edges = torch.zeros((), dtype=torch.int64, device=vol.device)
    for c in range(1, 8):
        dx, dy, dz = c >> 2 & 1, c >> 1 & 1, c & 1
        a = sign[:nx - dx, :ny - dy, :nz - dz]
        b = sign[dx:, dy:, dz:]
        n_edges = n_edges + (a != b).sum()
    return n_edges


def _extract_slab(vol, x0: int, sx: int, level: float, tab):
    """The slab's triangle slots in tet-major, triangle-minor order: edge
    keys (3T,) int64 and positions (3T, 3) f32 in grid coordinates."""
    _, ny, nz = vol.shape
    cy, cz = ny - 1, nz - 1
    ncell = sx * cy * cz
    tet_vals, case = _slab_cases(vol, x0, sx, level, tab)
    flat = ((case > 0) & (case < 15)).reshape(-1)  # (6*ncell,) tet-major
    sel = torch.nonzero(flat).squeeze(1)
    sel_tet = sel // ncell
    sel_cell = sel % ncell
    sel_case = case.reshape(-1)[sel]

    gz = sel_cell % cz
    gy = (sel_cell // cz) % cy
    gx = sel_cell // (cy * cz) + x0
    cell = torch.stack([gx, gy, gz], dim=-1)  # (T, 3)

    v4 = tet_vals[sel_tet, :, sel_cell]  # (T, 4)
    va = v4[:, tab["ea"]]  # (T, 6) per tet edge
    vb = v4[:, tab["eb"]]
    denom = vb - va
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    t = torch.clamp((level - va) / denom, 0.0, 1.0)  # (T, 6)

    node = cell[:, None, :] + tab["edge_lo"][sel_tet]  # (T, 6, 3)
    code = tab["edge_code"][sel_tet]                   # (T, 6)
    ekey = ((node[..., 0] * ny + node[..., 1]) * nz + node[..., 2]) * 8 \
        + code                                          # (T, 6)
    tc = torch.where(tab["edge_swap"][sel_tet], 1.0 - t, t)
    epos = node.to(torch.float32) + tc[..., None] * tab["dir_vec"][code]

    te = tab["tet_table"][sel_case]                    # (T, 6), -1 pad
    tesafe = te.clamp(min=0)
    vkn = torch.gather(ekey, 1, tesafe)                # (T, 6)
    vp = torch.gather(epos, 1, tesafe[..., None].expand(-1, -1, 3))
    # Triangle slots in tet-major, triangle-minor order; a tet's second
    # triangle exists only in the 2-2 cases.
    tri_valid = torch.stack([torch.ones_like(te[:, 3], dtype=torch.bool),
                             te[:, 3] >= 0], dim=1).reshape(-1)  # (2T,)
    keys = vkn.reshape(-1, 3)[tri_valid].reshape(-1)
    pos = vp.reshape(-1, 3, 3)[tri_valid].reshape(-1, 3)
    return keys, pos


def extract_isosurface_device(volume: torch.Tensor, level: float = 0.0,
                              slab_cells: int = 2_000_000):
    """Extraction on the volume's device: (verts (V, 3) f32 in GRID
    coordinates, faces (F, 3) int64), both on that device, exactly sized.
    Vertex ids follow ascending edge key; faces come slab by slab, tet by
    tet, as in the JAX package."""
    vol = volume.to(torch.float32).contiguous()
    dev = vol.device
    sx = slab_x_cells(vol.shape, slab_cells)
    tab = _tables(dev)
    keys = [torch.zeros((0,), dtype=torch.int64, device=dev)]
    pos = [torch.zeros((0, 3), dtype=torch.float32, device=dev)]
    for x0, sx_s in _slabs(vol.shape[0], sx):
        k, p = _extract_slab(vol, x0, sx_s, level, tab)
        keys.append(k)
        pos.append(p)
    keys, pos = torch.cat(keys), torch.cat(pos)
    n_tris = keys.shape[0] // 3
    if n_tris == 0:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int64, device=dev))

    # ---- weld: stable sort by edge key ----
    keys_s, order = torch.sort(keys, stable=True)
    newv = torch.ones_like(keys_s, dtype=torch.bool)
    newv[1:] = keys_s[1:] != keys_s[:-1]
    vid_sorted = torch.cumsum(newv, 0) - 1
    verts = pos[order[newv]]
    n_edges = int(crossing_edges(vol, level))
    if verts.shape[0] != n_edges:
        raise RuntimeError(f"marching: {verts.shape[0]} welded vertices, "
                           f"but {n_edges} grid edges cross the level")
    vids = torch.empty_like(vid_sorted)
    vids[order] = vid_sorted
    return verts, vids.reshape(n_tris, 3)


def extract_isosurface(volume, origin, spacing, level: float = 0.0,
                       slab_cells: int = 2_000_000, device=None):
    """Extract a triangle mesh from a dense SDF volume.

    volume: (nx, ny, nz) tensor or array; a tensor is processed on its
    device, an array on ``device`` (default: the GPU).  origin (3,),
    spacing (3,) map grid coords to world.  Returns (vertices (V, 3)
    f32, faces (F, 3) i32) as numpy arrays, welded exactly by grid-edge
    identity.
    """
    if not isinstance(volume, torch.Tensor):
        from myslam_torch import resolve_device

        volume = torch.as_tensor(np.asarray(volume, np.float32)).to(
            resolve_device(device))
    verts, faces = extract_isosurface_device(volume, level=level,
                                             slab_cells=slab_cells)
    origin = np.asarray(origin, np.float32)
    spacing = np.asarray(spacing, np.float32)
    verts = verts.cpu().numpy()
    return ((origin + verts * spacing).astype(np.float32),
            faces.cpu().numpy().astype(np.int32))
