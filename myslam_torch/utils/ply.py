"""Minimal PLY mesh IO (binary little-endian + ASCII read).

The port's copy of ``myslam_tpu/utils/ply.py`` (numpy only): for the
same arrays both write byte-identical files.  Triangle meshes with
optional uchar vertex colors.
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              vertex_colors: np.ndarray | None = None) -> None:
    """vertices (V,3) float; faces (F,3) int; colors (V,3) float[0,1] or uint8."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    has_color = vertex_colors is not None
    if has_color:
        c = np.asarray(vertex_colors)
        if c.dtype != np.uint8:
            c = np.clip(c * 255.0, 0, 255).astype(np.uint8)

    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {len(vertices)}",
                  "property float x", "property float y", "property float z"]
        if has_color:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(header) + "\n").encode())

        if has_color:
            vdt = np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            vbuf = np.empty(len(vertices), vdt)
            vbuf["xyz"] = vertices
            vbuf["rgb"] = c
        else:
            vbuf = vertices.astype("<f4")
        f.write(vbuf.tobytes())

        fdt = np.dtype([("n", np.uint8), ("idx", "<i4", 3)])
        fbuf = np.empty(len(faces), fdt)
        fbuf["n"] = 3
        fbuf["idx"] = faces
        f.write(fbuf.tobytes())


def read_ply(path: str):
    """Returns (vertices (V,3) f32, faces (F,3) i32, colors (V,3) u8 | None).

    Supports the binary-LE layout written by write_ply and simple ASCII
    PLY files (x y z [r g b] vertices, triangular faces).
    """
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = "ascii"
    n_vert = n_face = 0
    vert_props: list[tuple[str, str]] = []
    cur = None
    for line in header:
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur = t[1]
            if t[1] == "vertex":
                n_vert = int(t[2])
            elif t[1] == "face":
                n_face = int(t[2])
        elif t[0] == "property" and cur == "vertex" and t[1] != "list":
            vert_props.append((t[2], t[1]))

    names = [n for n, _ in vert_props]
    has_color = "red" in names

    if fmt == "ascii":
        text = body.decode("ascii").split("\n")
        vals = [list(map(float, l.split())) for l in text[:n_vert]]
        arr = np.asarray(vals, np.float32)
        ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
        verts = arr[:, [ix, iy, iz]]
        colors = None
        if has_color:
            ir = names.index("red")
            colors = arr[:, [ir, ir + 1, ir + 2]].astype(np.uint8)
        faces = np.asarray(
            [list(map(int, l.split()))[1:4] for l in text[n_vert:n_vert + n_face]],
            np.int32)
        return verts, faces, colors

    if fmt != "binary_little_endian":
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4"}
    vdt = np.dtype([(n, type_map[t]) for n, t in vert_props])
    vbytes = n_vert * vdt.itemsize
    varr = np.frombuffer(body[:vbytes], vdt, n_vert)
    verts = np.stack([varr["x"], varr["y"], varr["z"]], -1).astype(np.float32)
    colors = None
    if has_color:
        colors = np.stack(
            [varr["red"], varr["green"], varr["blue"]], -1).astype(np.uint8)
    fdt = np.dtype([("n", np.uint8), ("idx", "<i4", 3)])
    farr = np.frombuffer(body[vbytes:vbytes + n_face * fdt.itemsize], fdt,
                         n_face)
    faces = farr["idx"].astype(np.int32)
    return verts, faces, colors
