"""The port's own image files and the image operations its readers need.

The dataset readers of the JAX package decode with OpenCV; the port
reads and writes its frames itself, so it needs no image library:

  * PNG: 8-bit gray, RGB and RGBA, and 16-bit gray, not interlaced.
    The chunks are parsed and inflated here (``zlib``); the five row
    filters are undone in C++.  Writing uses filter 0.
  * JPEG: baseline sequential Huffman, 8-bit, 1 or 3 components,
    sampling factors up to 4 (2x2 in practice) and restart markers.  The
    markers and tables are parsed here; ``csrc/imagecodec.cpp`` decodes
    as libjpeg-turbo does with its defaults (the integer "islow" IDCT,
    fancy upsampling, its fixed-point YCbCr->RGB), which is what
    ``cv2.imread`` gives.  Progressive, arithmetic-coded, lossless,
    12-bit and CMYK files raise ``ValueError`` naming the mode.  Writing
    gives baseline 4:2:0 at a quality with IJG table scaling and the
    Annex K Huffman tables.
  * ``resize_linear`` (cv2.resize INTER_LINEAR, half-pixel centres),
    ``resize_nearest`` (INTER_NEAREST: ``src = floor(dst * in / out)``),
    ``resize_align_corners`` (bilinear, align_corners=True) and
    ``undistort`` (cv2.undistort with the camera matrix as the new one:
    k1 k2 p1 p2 k3, cv2's fixed-point map and bilinear remap with a
    constant-0 border).

Images are numpy arrays with channels last in RGB order: files store
RGB, so the BGR<->RGB swaps around OpenCV's calls have no counterpart.  The C++ is compiled with g++ at first
use into ``build/host/`` (keyed by a hash of its source and flags) and
bound with ctypes; its calls release the interpreter lock, so a prefetch
thread decodes while the loop runs.  A failed build or decode raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import struct
import subprocess
import threading
import time
import zlib

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "imagecodec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

# Seconds this process spent compiling the codec.
BUILD_SECONDS = 0.0
_lib = None
_lock = threading.Lock()

_ERRORS = {-1: "a PNG row has an unknown filter type",
           -2: "corrupt Huffman data or tables",
           -3: "a restart marker is missing or out of order",
           -4: "unsupported sampling factors",
           -5: "output buffer too small"}

# -- the C++ library ---------------------------------------------------------


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"imagecodec_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the codec unless it exists; return the library's path."""
    global BUILD_SECONDS
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH to build "
                           f"{SOURCE}")
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=600)
    BUILD_SECONDS += time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"building {SOURCE} failed:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load():
    """The codec's ctypes library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.png_unfilter.argtypes = [vp, ci, ci, ci, vp]
            lib.png_unfilter.restype = ci
            lib.jpeg_decode.argtypes = [vp, i64, ci, ci, ci, vp, vp, vp, vp,
                                        vp, vp, ci, ci, vp]
            lib.jpeg_decode.restype = ci
            lib.jpeg_encode.argtypes = [vp, ci, ci, vp, vp, vp, vp, i64]
            lib.jpeg_encode.restype = i64
            _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _check(rc: int, what: str) -> None:
    if rc < 0:
        raise ValueError(f"{what}: {_ERRORS.get(rc, f'error {rc}')}")


def _read_bytes(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    with open(src, "rb") as f:
        return f.read()


# -- PNG -----------------------------------------------------------------------

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels, for the types read and written here
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}


def read_png(src) -> np.ndarray:
    """Decode a PNG file (path or bytes): (H, W) uint8 / uint16 for gray,
    (H, W, 3) or (H, W, 4) uint8 for RGB / RGBA."""
    buf = _read_bytes(src)
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        crc = buf[pos + 8 + n:pos + 12 + n]
        if len(data) != n or len(crc) != 4:
            raise ValueError("truncated PNG file")
        if zlib.crc32(kind + data) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG file without IHDR or IDAT")
    W, H, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("Adam7-interlaced PNG is not supported")
    if ctype == 3:
        raise ValueError("palette PNG is not supported")
    if ctype not in _PNG_CHANNELS or (depth, ctype) not in (
            (8, 0), (16, 0), (8, 2), (8, 6)):
        raise ValueError(f"PNG of color type {ctype} at bit depth {depth} "
                         "is not supported (8-bit gray/RGB/RGBA, 16-bit "
                         "gray)")
    ch, nbytes = _PNG_CHANNELS[ctype], depth // 8
    rowbytes = W * ch * nbytes
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (rowbytes + 1):
        raise ValueError("PNG image data has the wrong size")
    out = np.empty((H, rowbytes), np.uint8)
    _check(load().png_unfilter(_ptr(raw), H, rowbytes, ch * nbytes,
                               _ptr(out)), "PNG")
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
    shape = (H, W) if ch == 1 else (H, W, ch)
    return out.reshape(shape)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of (H, W) uint8 / uint16 or (H, W, 3|4) uint8, every row
    with filter 0."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, rows = 16, 0, img.astype(">u2").view(np.uint8)
    elif img.dtype == np.uint8 and (img.ndim == 2 or img.shape[-1] in (3, 4)):
        depth = 8
        ctype = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[-1]]
        rows = img
    else:
        raise ValueError(f"cannot write a PNG of {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    rows = np.ascontiguousarray(rows).reshape(H, -1)
    raw = np.zeros((H, rows.shape[1] + 1), np.uint8)
    raw[:, 1:] = rows
    return (PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _png_chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# -- JPEG ----------------------------------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# ITU T.81 Annex K.1: quantization tables (natural order) for quality 50.
STD_QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_QUANT_CHROMA = np.array(
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)

# Annex K.3: the standard Huffman tables, (16 counts, values).
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
STD_HUFFMAN = (  # DC luma, AC luma, DC chroma, AC chroma
    (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]),
     _AC_LUMA_VALS),
    (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]),
     _AC_CHROMA_VALS),
)

_MARKER = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_SOF_MODES = {
    0xC2: "progressive", 0xC6: "progressive (differential)",
    0xC3: "lossless", 0xC7: "lossless (differential)",
    0xC5: "hierarchical (differential sequential)",
    0xC9: "arithmetic-coded", 0xCA: "progressive arithmetic-coded",
    0xCB: "lossless arithmetic-coded", 0xCD: "arithmetic-coded",
    0xCE: "progressive arithmetic-coded", 0xCF: "lossless arithmetic-coded"}


def _jpeg_parse(buf: bytes) -> dict:
    """Frame, tables and the one scan's entropy-coded data of a baseline
    JPEG; raises ValueError naming any mode it does not decode."""
    if buf[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    pos, qt, huff = 2, {}, {}
    frame, restart, adobe, scan = None, 0, None, None
    while scan is None:
        if pos >= len(buf) or buf[pos] != 0xFF:
            raise ValueError("corrupt JPEG: marker expected")
        while pos < len(buf) and buf[pos] == 0xFF:
            pos += 1
        if pos >= len(buf):
            raise ValueError("truncated JPEG file")
        m = buf[pos]
        pos += 1
        if m in (0x01, 0xD8) or 0xD0 <= m <= 0xD7:
            continue
        if m == 0xD9:
            raise ValueError("JPEG file without a scan")
        (n,) = struct.unpack(">H", buf[pos:pos + 2])
        seg = buf[pos + 2:pos + n]
        pos += n
        if m in _SOF_MODES:
            raise ValueError(f"{_SOF_MODES[m]} JPEG is not supported "
                             "(baseline sequential Huffman only)")
        if m == 0xCC:
            raise ValueError("arithmetic-coded JPEG is not supported")
        if m == 0xDB:
            k = 0
            while k < len(seg):
                pq, tq = seg[k] >> 4, seg[k] & 15
                n_b = 128 if pq else 64
                vals = np.frombuffer(seg[k + 1:k + 1 + n_b],
                                     ">u2" if pq else np.uint8)
                table = np.zeros(64, np.uint16)
                table[ZIGZAG] = vals
                qt[tq] = table
                k += 1 + n_b
        elif m == 0xC4:
            k = 0
            while k < len(seg):
                tc_th = seg[k]
                counts = seg[k + 1:k + 17]
                total = sum(counts)
                huff[tc_th] = (counts, seg[k + 17:k + 17 + total])
                k += 17 + total
        elif m == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif m in (0xC0, 0xC1):
            precision, H, W, nf = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG is not supported "
                                 "(8-bit only)")
            if nf == 4:
                raise ValueError("CMYK (4-component) JPEG is not supported")
            if nf not in (1, 3):
                raise ValueError(f"JPEG with {nf} components is not "
                                 "supported")
            comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4,
                      seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                     for i in range(nf)]
            frame = (H, W, comps)
        elif m == 0xEE and seg[:5] == b"Adobe":
            adobe = seg[11]
        elif m == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = seg[0]
            sel = {seg[1 + 2 * i]: seg[2 + 2 * i] for i in range(ns)}
            if ns != len(frame[2]):
                raise ValueError("JPEG with more than one scan is not "
                                 "supported")
            end = _MARKER.search(buf, pos)
            if end is None or buf[end.start() + 1] != 0xD9:
                raise ValueError(
                    "truncated JPEG, or one with more than one scan")
            scan = (sel, buf[pos:end.start() + 2])
    H, W, comps = frame
    if H == 0:
        raise ValueError("JPEG with its height in a DNL marker")
    sel, data = scan
    n = len(comps)
    hv = np.array([(h, v) for _, h, v, _ in comps], np.int32)
    tables = {"dc_bits": np.zeros((n, 16), np.uint8),
              "dc_vals": np.zeros((n, 256), np.uint8),
              "ac_bits": np.zeros((n, 16), np.uint8),
              "ac_vals": np.zeros((n, 256), np.uint8)}
    for c, (cid, _, _, tq) in enumerate(comps):
        if cid not in sel or tq not in qt:
            raise ValueError("JPEG scan or quantization table missing")
        for kind, key in (("dc", sel[cid] >> 4), ("ac", 16 + (sel[cid] & 15))):
            if key not in huff:
                raise ValueError("JPEG Huffman table missing")
            counts, vals = huff[key]
            tables[kind + "_bits"][c] = np.frombuffer(counts, np.uint8)
            tables[kind + "_vals"][c, :len(vals)] = np.frombuffer(
                vals, np.uint8)
    # libjpeg's colorspace guess: an Adobe marker's transform, else
    # component ids 'R', 'G', 'B' mean RGB; otherwise YCbCr.
    ycc = n == 3 and not (adobe == 0 or [c[0] for c in comps] == [82, 71,
                                                                   66])
    return {"H": H, "W": W, "n": n, "hv": hv, "restart": restart,
            "ycc": ycc, "data": data,
            "qt": np.stack([qt[tq] for *_, tq in comps]), **tables}


def read_jpeg(src) -> np.ndarray:
    """Decode a baseline JPEG (path or bytes): (H, W, 3) uint8 RGB, or
    (H, W) uint8 for a gray file."""
    j = _jpeg_parse(_read_bytes(src))
    out = np.empty((j["H"], j["W"], j["n"]), np.uint8)
    data = np.frombuffer(j["data"], np.uint8)
    arrays = [np.ascontiguousarray(j[k]) for k in (
        "hv", "qt", "dc_bits", "dc_vals", "ac_bits", "ac_vals")]
    _check(load().jpeg_decode(
        _ptr(data), data.size, j["W"], j["H"], j["n"],
        *(_ptr(a) for a in arrays), j["restart"], int(j["ycc"]), _ptr(out)),
        "JPEG")
    return out[..., 0] if j["n"] == 1 else out


def quant_tables(quality: int) -> np.ndarray:
    """The two quantization tables (natural order) at an IJG quality
    (jcparam.c: jpeg_quality_scaling, baseline-limited to 1..255)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.stack([np.clip((t * scale + 50) // 100, 1, 255)
                     for t in (STD_QUANT_LUMA, STD_QUANT_CHROMA)]).astype(
                         np.uint16)


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """Baseline JPEG bytes of an (H, W, 3) uint8 RGB image: JFIF, 4:2:0
    YCbCr, IJG tables at ``quality``, the standard Huffman tables."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"cannot write a JPEG of {rgb.dtype} {rgb.shape}")
    H, W = rgb.shape[:2]
    qt = quant_tables(quality)
    bits = np.frombuffer(b"".join(b for b, _ in STD_HUFFMAN), np.uint8)
    vals = np.frombuffer(b"".join(v for _, v in STD_HUFFMAN), np.uint8)
    cap = 2 * H * W * 3 + (1 << 16)
    while True:
        out = np.empty(cap, np.uint8)
        n = load().jpeg_encode(_ptr(rgb), W, H, _ptr(qt), _ptr(bits),
                               _ptr(vals), _ptr(out), cap)
        if n >= 0:
            break
        cap *= 2
    head = [b"\xff\xd8",
            b"\xff\xe0" + struct.pack(">H5sBBBHHBB", 16, b"JFIF\0", 1, 1, 0,
                                      1, 1, 0, 0)]
    for t in range(2):
        head.append(b"\xff\xdb" + struct.pack(">HB", 67, t)
                    + qt[t][ZIGZAG].astype(np.uint8).tobytes())
    head.append(b"\xff\xc0" + struct.pack(
        ">HBHHB", 17, 8, H, W, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11,
                                            1]))
    for tc_th, (counts, values) in zip((0x00, 0x10, 0x01, 0x11),
                                       STD_HUFFMAN):
        head.append(b"\xff\xc4" + struct.pack(">HB", 3 + 16 + len(values),
                                              tc_th) + counts + values)
    head.append(b"\xff\xda" + struct.pack(">HB", 12, 3)
                + bytes([1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return b"".join(head) + out[:n].tobytes() + b"\xff\xd9"


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb, quality))


# -- reading by file type ------------------------------------------------------


def imread(path: str) -> np.ndarray:
    """A PNG or JPEG file as stored: gray (H, W) uint8/uint16, or color
    (H, W, 3|4) uint8 in RGB(A) order."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] == PNG_SIGNATURE:
        return read_png(buf)
    if buf[:2] == b"\xff\xd8":
        return read_jpeg(buf)
    raise ValueError(f"{path}: neither PNG nor JPEG")


def imread_rgb(path: str) -> np.ndarray:
    """An 8-bit PNG or JPEG file as (H, W, 3) uint8 RGB: gray is
    replicated and alpha dropped, as cv2.imread's color mode does."""
    img = imread(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: {img.dtype} is not an 8-bit color image")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


# -- resizing and undistortion ---------------------------------------------------


def _linear_taps(n_in: int, n_out: int):
    """cv2.resize INTER_LINEAR's source index and weight per output
    index: half-pixel centres, clamped to the edge samples."""
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out)
         - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    w = (f - s.astype(np.float32)).astype(np.float32)
    w[s < 0] = 0
    s[s < 0] = 0
    hi = s >= n_in - 1
    w[hi] = 0
    s[hi] = n_in - 1
    return s, np.minimum(s + 1, n_in - 1), w


def resize_linear(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """cv2.resize(img, (out_w, out_h)) of a float32 (H, W[, C]) image
    (INTER_LINEAR; an exact halving averages 2x2 as cv2 does)."""
    img = np.asarray(img, np.float32)
    in_h, in_w = img.shape[:2]
    if in_w == 2 * out_w and in_h == 2 * out_h:
        return ((img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2]
                 + img[1::2, 1::2]) * np.float32(0.25)).astype(np.float32)
    x0, x1, wx = _linear_taps(in_w, out_w)
    y0, y1, wy = _linear_taps(in_h, out_h)
    extra = (None,) * (img.ndim - 2)  # broadcast over channels
    wx, wy = wx[(slice(None),) + extra], wy[(slice(None), None) + extra]
    rows = img[:, x0] * (np.float32(1) - wx) + img[:, x1] * wx
    return rows[y0] * (np.float32(1) - wy) + rows[y1] * wy


def resize_nearest(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """cv2.resize(img, (out_w, out_h), interpolation=INTER_NEAREST):
    source index floor(dst * in / out), clamped."""
    in_h, in_w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / in_w))),
                    in_w - 1).astype(np.int64)
    ys = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / in_h))),
                    in_h - 1).astype(np.int64)
    return img[ys][:, xs]


def resize_align_corners(img: np.ndarray, out_h: int,
                         out_w: int) -> np.ndarray:
    """Bilinear resize with align_corners=True (torch F.interpolate
    semantics; cv2.resize uses half-pixel centres, which differs at the
    borders)."""
    in_h, in_w = img.shape[:2]
    ys = np.linspace(0, in_h - 1, out_h, dtype=np.float32)
    xs = np.linspace(0, in_w - 1, out_w, dtype=np.float32)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img3 = img if img.ndim == 3 else img[..., None]
    out = (
        img3[y0][:, x0] * (1 - wy) * (1 - wx)
        + img3[y0][:, x1] * (1 - wy) * wx
        + img3[y1][:, x0] * wy * (1 - wx)
        + img3[y1][:, x1] * wy * wx
    )
    return out if img.ndim == 3 else out[..., 0]


INTER_BITS = 5  # cv2's remap: 1/32-pixel fixed-point coordinates
REMAP_COEF_BITS = 15


def undistort_map(K: np.ndarray, dist, H: int, W: int):
    """cv2.initUndistortRectifyMap(K, dist, I, K, (W, H), CV_16SC2) as
    cv2.undistort builds it: for each output pixel the distorted source
    position in 1/32 pixels, as (integer x, integer y, fraction index).
    ``dist``: k1, k2, p1, p2[, k3]."""
    K = np.asarray(K, np.float64)
    d = np.zeros(5)
    d[:len(dist)] = np.asarray(dist, np.float64)[:5]
    k1, k2, p1, p2, k3 = d
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ir = np.linalg.inv(K).reshape(-1)
    # The running sums cv2 keeps along a row, in its order.
    step = np.full(W, ir[0])
    xs = np.empty((H, W))
    rows = np.arange(H, dtype=np.float64)
    x0 = rows * ir[1] + ir[2]
    for i in range(H):
        step[0] = x0[i]
        np.cumsum(step, out=xs[i])
    ys = np.repeat((rows * ir[4] + ir[5])[:, None], W, axis=1)
    w = 1.0 / (rows * ir[7] + ir[8])[:, None]
    x, y = xs * w, ys * w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + u0
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + v0
    iu = np.rint(u * (1 << INTER_BITS)).astype(np.int64)
    iv = np.rint(v * (1 << INTER_BITS)).astype(np.int64)
    mask = (1 << INTER_BITS) - 1
    return iu >> INTER_BITS, iv >> INTER_BITS, iu & mask, iv & mask


def undistort(img: np.ndarray, K: np.ndarray, dist) -> np.ndarray:
    """cv2.undistort(img, K, dist) of a uint8 (H, W[, C]) image: the new
    camera is K; bilinear remap in cv2's fixed point (weights of 15 bits
    at 1/32-pixel positions); taps outside the image read 0."""
    if img.dtype != np.uint8:
        raise ValueError(f"undistort takes uint8 images, not {img.dtype}")
    H, W = img.shape[:2]
    sx, sy, fx, fy = undistort_map(K, dist, H, W)
    n = 1 << INTER_BITS
    # cv2's table: (n - fx)(n - fy) ... at 32 * (1/32)^2 scale, exact.
    scale = (1 << REMAP_COEF_BITS) // (n * n)
    taps = (((0, 0), (n - fx) * (n - fy)), ((1, 0), fx * (n - fy)),
            ((0, 1), (n - fx) * fy), ((1, 1), fx * fy))
    img3 = img if img.ndim == 3 else img[..., None]
    acc = np.zeros(img3.shape, np.int64)
    for (dx, dy), wgt in taps:
        xx, yy = sx + dx, sy + dy
        inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        vals = img3[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)].astype(
            np.int64)
        acc += np.where(inside, wgt * scale, 0)[..., None] * vals
    out = np.clip((acc + (1 << (REMAP_COEF_BITS - 1))) >> REMAP_COEF_BITS,
                  0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]
