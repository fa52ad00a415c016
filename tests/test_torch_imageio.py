"""The port's image codec and image operations against OpenCV.

``myslam_torch/utils/imageio.py`` (with ``csrc/imagecodec.cpp``) replaces
the JAX package's OpenCV calls.  Stated tolerances:

  * PNG decode: byte-equal to ``cv2.imread(..., IMREAD_UNCHANGED)``, on
    files this test writes with zlib, one per row filter (0-4) for 8-bit
    RGB and 16-bit gray;
  * JPEG decode: equal to ``cv2.imread`` (0 values differ) on the JAX
    exporter's 4:2:0 frames and on OpenCV-written 4:4:4 (with a restart
    interval), 4:2:2, 4:4:0 and gray files of odd sizes;
  * the port's JPEG at quality 95, decoded by OpenCV, within the error of
    OpenCV's own quality-95 round trip on the same full-width render,
    which chip_smoke.py carries as its gate (JPEG_Q95_MAX_ERR,
    JPEG_Q95_MEAN_ERR);
  * ``undistort``: equal to ``cv2.undistort`` (0 levels) with
    freiburg1_desk.yaml's coefficients; OpenCV's fixed-point map and
    remap are reproduced;
  * ``resize_nearest``: equal to INTER_NEAREST; ``resize_linear``:
    within 2e-6 of INTER_LINEAR on float32 values in [0, 1] (float
    rounding of the weights).
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from myslam_torch.utils import imageio
from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smooth(H, W, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / 17 + y / 23),
                    128 + 90 * np.cos(x / 11 - y / 29),
                    128 + 80 * np.sin((x + y) / 13)], -1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _filter_rows(rows: np.ndarray, bpp: int, ftype: int) -> bytes:
    """PNG rows (H, rowbytes) filtered with one filter type (a plain
    transcription of the PNG specification, section 9)."""
    H, n = rows.shape
    out = bytearray()
    prev = np.zeros(n, np.int64)
    for r in rows.astype(np.int64):
        f = np.zeros(n, np.int64)
        for i in range(n):
            a = r[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            f[i] = (r[i] - pred) % 256
        out += bytes([ftype]) + bytes(f.astype(np.uint8))
        prev = r
    return bytes(out)


def _png(img: np.ndarray, ftype: int) -> bytes:
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    H, W = img.shape[:2]
    if img.dtype == np.uint16:
        depth, ctype, bpp = 16, 0, 2
        rows = img.astype(">u2").view(np.uint8).reshape(H, -1)
    else:
        depth, ctype, bpp = 8, 2, 3
        rows = img.reshape(H, -1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(_filter_rows(rows, bpp, ftype)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb8", "gray16"])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decode_is_byte_equal_to_opencv(tmp_path, kind, ftype):
    rng = np.random.default_rng(ftype)
    if kind == "rgb8":
        img = _smooth(13, 17, ftype)
    else:
        img = rng.integers(0, 65536, (11, 19)).astype(np.uint16)
    path = str(tmp_path / f"{kind}_{ftype}.png")
    with open(path, "wb") as f:
        f.write(_png(img, ftype))
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = imageio.read_png(path)
    if kind == "rgb8":
        ref = ref[..., ::-1]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)
    # And the port's writer, read by OpenCV.
    out = str(tmp_path / "port.png")
    imageio.write_png(out, img)
    back = cv2.imread(out, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1] if kind == "rgb8" else
                                  back, img)


def test_png_modes_not_read_raise():
    buf = bytearray(_png(_smooth(4, 4), 0))
    ihdr = 8 + 8  # the IHDR data
    for offset, value, what in ((12, 1, "interlaced"), (9, 3, "palette")):
        bad = bytearray(buf)
        bad[ihdr + offset] = value
        crc = zlib.crc32(bytes(bad[12:ihdr + 13]))
        bad[ihdr + 13:ihdr + 17] = struct.pack(">I", crc)
        with pytest.raises(ValueError, match=what):
            imageio.read_png(bytes(bad))


def _cv2_jpeg(img, *params):
    ok, buf = cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3 else img,
                           list(params))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("case", ["444_restart", "422", "440", "gray",
                                  "420_odd"])
def test_jpeg_decode_equals_opencv(case):
    img = _smooth(37, 53, 3)
    q = cv2.IMWRITE_JPEG_QUALITY
    s = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    buf = {
        "444_restart": lambda: _cv2_jpeg(img, q, 90, s, 0x111111,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
        "422": lambda: _cv2_jpeg(img, q, 85, s, 0x211111),
        "440": lambda: _cv2_jpeg(img, q, 85, s, 0x121111),
        "gray": lambda: _cv2_jpeg(img[..., 1], q, 90),
        "420_odd": lambda: _cv2_jpeg(img[:17, :5], q, 98),
    }[case]()
    ref = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED)
    got = imageio.read_jpeg(buf)
    if ref.ndim == 3:
        ref = ref[..., ::-1]
    assert got.shape == ref.shape
    assert int((got != ref).sum()) == 0


def test_jpeg_decode_equals_opencv_on_the_jax_exporters_frames(tmp_path):
    """The JAX exporter's Replica frames (cv2, quality 98, 4:2:0)."""
    from myslam_tpu.tools.export_synthetic import export_replica

    cfg = load_config(os.path.join(REPO, "configs", "Synthetic",
                                   "room.yaml"), DEFAULT_CONFIG)
    cfg["cam"].update(H=61, W=83, fx=50.0, fy=50.0, cx=41.0, cy=30.0)
    export_replica(cfg, str(tmp_path), n_frames=3, holes=True)
    for i in range(3):
        path = str(tmp_path / "results" / f"frame{i:06d}.jpg")
        ref = cv2.imread(path)[..., ::-1]
        got = imageio.imread_rgb(path)
        assert int((got != ref).sum()) == 0


def _patched_sof(buf: bytes, marker=None, precision=None, ncomp=None):
    i = buf.index(b"\xff\xc0")
    b = bytearray(buf)
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    if ncomp is not None:
        b[i + 9] = ncomp
    return bytes(b)


@pytest.mark.parametrize("mode", ["progressive", "arithmetic-coded",
                                  "12-bit", "CMYK", "lossless"])
def test_jpeg_modes_not_decoded_raise_naming_the_mode(mode):
    img = _smooth(16, 16)
    base = _cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, 90)
    buf = {
        "progressive": lambda: _cv2_jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE,
                                         1),
        "arithmetic-coded": lambda: _patched_sof(base, marker=0xC9),
        "12-bit": lambda: _patched_sof(base, precision=12),
        "CMYK": lambda: _patched_sof(base, ncomp=4),
        "lossless": lambda: _patched_sof(base, marker=0xC3),
    }[mode]()
    with pytest.raises(ValueError, match=mode):
        imageio.read_jpeg(buf)


def test_port_jpeg_is_within_opencvs_q95_error():
    """The port's quality-95 JPEG of frame 0 of room.yaml at 680x1200:
    OpenCV decodes it as the port does, within the error of OpenCV's own
    quality-95 round trip, which is chip_smoke.py's gate."""
    import chip_smoke
    from myslam_torch.utils.datasets import Synthetic

    cfg = load_config(os.path.join(REPO, "configs", "Synthetic",
                                   "room.yaml"), DEFAULT_CONFIG)
    color, _, _ = Synthetic(cfg).get_frame(0)
    rgb = (np.clip(color, 0, 1) * 255).astype(np.uint8)
    ours = imageio.encode_jpeg(rgb, 95)
    by_cv2 = cv2.imdecode(np.frombuffer(ours, np.uint8),
                          cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(imageio.read_jpeg(ours), by_cv2)
    theirs = cv2.imdecode(np.frombuffer(_cv2_jpeg(
        rgb, cv2.IMWRITE_JPEG_QUALITY, 95), np.uint8), cv2.IMREAD_COLOR)
    cv2_err = np.abs(theirs[..., ::-1].astype(np.int64) - rgb)
    assert (int(cv2_err.max()), round(float(cv2_err.mean()), 4)) == (
        chip_smoke.JPEG_Q95_MAX_ERR, chip_smoke.JPEG_Q95_MEAN_ERR)
    err = np.abs(by_cv2.astype(np.int64) - rgb)
    assert err.max() <= cv2_err.max() and err.mean() <= cv2_err.mean()
    # The file is baseline 4:2:0 at the IJG tables of quality 95.
    assert b"\xff\xc0" in ours and b"\xff\xc2" not in ours
    np.testing.assert_array_equal(imageio.quant_tables(95)[0][:3], [2, 1, 1])


def test_undistort_equals_opencv_with_freiburg1_desk_coefficients():
    cfg = load_config(os.path.join(REPO, "configs", "TUM_RGBD",
                                   "freiburg1_desk.yaml"), DEFAULT_CONFIG)
    cam = cfg["cam"]
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                  [0, 0, 1]])
    img = _smooth(cam["H"], cam["W"], 5)
    dist = np.array(cam["distortion"])
    got = imageio.undistort(img, K, dist)
    ref = cv2.undistort(img, K, dist)
    assert int((got != ref).sum()) == 0
    assert int((got == 0).all(-1).sum()) > 0  # the border reads 0
    np.testing.assert_array_equal(
        imageio.undistort(img[..., 0], K, dist), cv2.undistort(
            np.ascontiguousarray(img[..., 0]), K, dist))


@pytest.mark.parametrize("sizes", [(640, 480, 512, 384), (53, 37, 20, 50),
                                   (64, 48, 32, 24), (30, 20, 77, 41)])
def test_resizes_match_opencv(sizes):
    iw, ih, ow, oh = sizes
    src = np.random.default_rng(iw).random((ih, iw, 3)).astype(np.float32)
    np.testing.assert_allclose(imageio.resize_linear(src, ow, oh),
                               cv2.resize(src, (ow, oh)), atol=2e-6, rtol=0)
    np.testing.assert_array_equal(
        imageio.resize_nearest(src[..., 0], ow, oh),
        cv2.resize(src[..., 0], (ow, oh), interpolation=cv2.INTER_NEAREST))
