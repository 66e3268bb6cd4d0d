"""ctypes bindings for the host image arithmetic of the augmentation chains
(``ssd_image_ops.cpp``): resize in OpenCV's five modes, the affine warp and
the RGB/HSV/GRAY conversions, one (H, W, C) image per call.

``data/geometric.py:resize_image`` and ``warp_affine`` and
``data/photometric.py:cvt_color`` call these for uint8, uint16, int16,
float32 and float64 images (a nearest resize also for the other types of
``NEAREST_DTYPES``). Python computes each resize's tap indices and weights
and each warp's source positions, as the NumPy functions do, and passes
them in; the C++ runs the per-pixel loops in the
NumPy functions' order of operations, so the results equal the plain
versions (``resize_image_numpy``, ``warp_affine_numpy``,
``cvt_color_numpy``) bit for bit. ``g++ -O3 -shared -fPIC
-ffp-contract=off -fno-tree-vectorize`` builds the source at its first use
into ``ssd_keras_torch/_build/`` (``native._build``: a private name, then a
rename); a missing ``g++`` or a failed build raises ``RuntimeError`` with
the compiler's message. Nothing falls back to NumPy.

Every function checks the shape, dtype and contiguity of each array, and
the range of each index, before a pointer goes to C, and returns a new
NumPy array. ``image_ops_calls`` counts the C calls by op.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["image_ops_calls", "load_image_ops", "DTYPES", "NEAREST_DTYPES", "IMAGE_OPS_SOURCE",
           "IMAGE_OPS_FLAGS",
           "resize_nearest", "resize_linear_u8", "resize_separable", "resize_fixed_u8",
           "resize_block_mean", "warp_affine", "warp_remap", "cvt_color"]

IMAGE_OPS_SOURCE = Path(__file__).resolve().parent / "ssd_image_ops.cpp"
# No contraction of a * b + c into one rounding: the NumPy versions round
# each product and each sum. No loop vectorizer: g++ 12's, at -O3, keeps
# warp_affine's float32 top and bottom lerps in double across the rounding
# to float32 that the NumPy version (and OpenCV) makes between them.
IMAGE_OPS_FLAGS = ("-ffp-contract=off", "-fno-tree-vectorize")
# The image types the C++ takes, by its dtype code.
DTYPES = {np.dtype(np.uint8): 0, np.dtype(np.float32): 1, np.dtype(np.float64): 2,
          np.dtype(np.uint16): 3, np.dtype(np.int16): 4}
# The types a nearest resize (a gather by item size) takes: those of
# DTYPES and the others that cv2.resize takes in INTER_NEAREST and keeps
# (float16 goes through NumPy, as in every mode).
NEAREST_DTYPES = {**DTYPES, **{np.dtype(t): -1 for t in (np.int8, np.uint32, np.int32,
                                                          np.bool_)}}
_CVT_CODES = {("RGB", "HSV"): 0, ("HSV", "RGB"): 1, ("RGB", "GRAY"): 2}
# The types each conversion takes, as cv2.cvtColor.
_CVT_DTYPES = {"GRAY": {np.dtype(np.uint8): 0, np.dtype(np.float32): 1, np.dtype(np.uint16): 3},
               "HSV": {np.dtype(np.uint8): 0, np.dtype(np.float32): 1}}

# C calls by op since the process started (or since a caller reset them): a
# run can show that its images went through the native code.
image_ops_calls = {"resize": 0, "warp_affine": 0, "cvt_color": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def load_image_ops() -> ctypes.CDLL:
    """Build (if needed) and load ``ssd_image_ops.cpp``; declares every entry."""
    from ssd_keras_torch import native

    path = native._library_path(IMAGE_OPS_SOURCE, flags=IMAGE_OPS_FLAGS)
    if not path.exists():
        native._build(path, IMAGE_OPS_SOURCE, flags=IMAGE_OPS_FLAGS)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    signatures = {
        "ssd_resize_nearest": [_P, _I64, _I64, _P, _I64, _P, _I64, _P],
        "ssd_resize_linear_u8": [_P, _I64, _I64, _I64, _P, _P, _P, _P, _I64,
                                 _P, _P, _P, _P, _I64, _P],
        "ssd_resize_separable": [ctypes.c_int, _P, _I64, _I64, _I64, _P, _P, _I64, _I64,
                                 _P, _P, _I64, _I64, ctypes.c_int, _I64, _P],
        "ssd_resize_fixed_u8": [_P, _I64, _I64, _I64, _P, _P, _I64, _I64, _P, _P, _I64, _I64,
                                _I64, _P],
        "ssd_resize_block_mean": [ctypes.c_int, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                                  ctypes.c_int, _I64, _P],
        "ssd_warp_affine": [ctypes.c_int, _P, _I64, _I64, _I64, _P, _P, _I64, _I64, _P],
        "ssd_warp_remap": [ctypes.c_int, _P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _I64,
                           _I64, _P],
        "ssd_cvt_color": [ctypes.c_int, ctypes.c_int, _P, _I64, _I64, _P, _P, _P],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = argtypes
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _planes(image: np.ndarray, dtypes=DTYPES) -> np.ndarray:
    """``image`` itself if it is a C-contiguous (H, W, C) array of a type the
    C++ takes, with no empty axis; raises otherwise."""
    if not isinstance(image, np.ndarray) or image.ndim != 3:
        raise ValueError(f"expected an (H, W, C) array, got {getattr(image, 'shape', image)}")
    if image.dtype not in dtypes:
        raise TypeError(f"the native image ops take {sorted(str(d) for d in dtypes)} images, "
                        f"got {image.dtype}")
    if not image.flags.c_contiguous:
        raise ValueError("the native image ops take C-contiguous images")
    if 0 in image.shape:
        raise ValueError(f"empty image of shape {image.shape}")
    return image


def _table(a, dtype, shape: Tuple[int, ...], name: str) -> np.ndarray:
    """``a`` as a C-contiguous array of ``dtype`` and ``shape``; raises on
    another shape."""
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.shape != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {a.shape}")
    return a


def _index(a, shape: Tuple[int, ...], size: int, name: str) -> np.ndarray:
    """A table of source indices, each in [0, size)."""
    a = _table(a, np.int64, shape, name)
    if a.size and (a.min() < 0 or a.max() >= size):
        raise ValueError(f"{name}: an index outside [0, {size})")
    return a


def _accumulator(dtype: np.dtype) -> np.dtype:
    """The type the C++ sums a resize or warp of ``dtype`` in."""
    return np.dtype(np.float64) if dtype == np.float64 else np.dtype(np.float32)


def resize_nearest(image: np.ndarray, ys, xs) -> np.ndarray:
    """``out[i, j] = image[ys[i], xs[j]]``, for any type of
    ``NEAREST_DTYPES``."""
    image = _planes(image, NEAREST_DTYPES)
    h, w, c = image.shape
    ys = _index(ys, np.shape(ys), h, "ys")
    xs = _index(xs, np.shape(xs), w, "xs")
    if ys.ndim != 1 or xs.ndim != 1:
        raise ValueError("ys and xs must be one-dimensional")
    out = np.empty((ys.size, xs.size, c), image.dtype)
    load_image_ops().ssd_resize_nearest(_ptr(image), w, c * image.itemsize, _ptr(ys), ys.size,
                                        _ptr(xs), xs.size, _ptr(out))
    image_ops_calls["resize"] += 1
    return out


def resize_linear_u8(image: np.ndarray, xtaps, ytaps) -> np.ndarray:
    """OpenCV's fixed-point INTER_LINEAR of a uint8 image; each of ``xtaps``
    and ``ytaps`` is (first index, second index, its int32 weight, the
    second's), one entry per output column or row."""
    image = _planes(image, {np.dtype(np.uint8): 0})
    h, w, c = image.shape
    out_w, out_h = np.shape(xtaps[0])[0], np.shape(ytaps[0])[0]
    x0, x1 = (_index(t, (out_w,), w, "xtaps") for t in xtaps[:2])
    a0, a1 = (_table(t, np.int32, (out_w,), "xtaps") for t in xtaps[2:])
    y0, y1 = (_index(t, (out_h,), h, "ytaps") for t in ytaps[:2])
    b0, b1 = (_table(t, np.int32, (out_h,), "ytaps") for t in ytaps[2:])
    out = np.empty((out_h, out_w, c), np.uint8)
    load_image_ops().ssd_resize_linear_u8(
        _ptr(image), h, w, c, _ptr(x0), _ptr(x1), _ptr(a0), _ptr(a1), out_w,
        _ptr(y0), _ptr(y1), _ptr(b0), _ptr(b1), out_h, _ptr(out))
    image_ops_calls["resize"] += 1
    return out


def resize_separable(image: np.ndarray, xi, xw, yi, yw, x_from_zero: bool = False,
                     lanes: int = 0) -> np.ndarray:
    """A separable resize by (out, k) tap tables: indices ``xi``/``yi`` and
    weights ``xw``/``yw`` in the accumulator type (float64 for float64
    images, float32 for the others). Each horizontal sum starts from its
    first product, or from 0 with ``x_from_zero``. The vertical sum runs
    forward, or with ``lanes`` in reverse on the first ``n - n % lanes``
    elements of each output row (OpenCV's vector pass). Integer images are
    rounded half to even and saturated."""
    image = _planes(image)
    h, w, c = image.shape
    acc = _accumulator(image.dtype)
    (out_w, kx), (out_h, ky) = np.shape(xi), np.shape(yi)
    xi = _index(xi, (out_w, kx), w, "xi")
    yi = _index(yi, (out_h, ky), h, "yi")
    xw = _table(xw, acc, (out_w, kx), "xw")
    yw = _table(yw, acc, (out_h, ky), "yw")
    if kx < 1 or ky < 1:
        raise ValueError("a resize needs at least one tap on each axis")
    if lanes < 0:
        raise ValueError(f"lanes {lanes}")
    out = np.empty((out_h, out_w, c), image.dtype)
    load_image_ops().ssd_resize_separable(
        DTYPES[image.dtype], _ptr(image), h, w, c, _ptr(xi), _ptr(xw), kx, out_w,
        _ptr(yi), _ptr(yw), ky, out_h, int(bool(x_from_zero)), int(lanes), _ptr(out))
    image_ops_calls["resize"] += 1
    return out


def resize_fixed_u8(image: np.ndarray, xi, xw, yi, yw, lanes: int = 0) -> np.ndarray:
    """OpenCV's fixed-point INTER_LANCZOS4 and INTER_CUBIC of a uint8 image:
    int32 weights (11-bit), sums in int64, ``(total + (1 << 21)) >> 22``;
    with ``lanes``, the first ``n - n % lanes`` elements of each output row
    take the vertical sum in float32 instead, in reverse, on the weights
    times 2**-22, rounded half to even."""
    image = _planes(image, {np.dtype(np.uint8): 0})
    h, w, c = image.shape
    (out_w, kx), (out_h, ky) = np.shape(xi), np.shape(yi)
    xi = _index(xi, (out_w, kx), w, "xi")
    yi = _index(yi, (out_h, ky), h, "yi")
    xw = _table(xw, np.int32, (out_w, kx), "xw")
    yw = _table(yw, np.int32, (out_h, ky), "yw")
    if lanes < 0:
        raise ValueError(f"lanes {lanes}")
    out = np.empty((out_h, out_w, c), np.uint8)
    load_image_ops().ssd_resize_fixed_u8(
        _ptr(image), h, w, c, _ptr(xi), _ptr(xw), kx, out_w, _ptr(yi), _ptr(yw), ky, out_h,
        int(lanes), _ptr(out))
    image_ops_calls["resize"] += 1
    return out


def resize_block_mean(image: np.ndarray, out_h: int, out_w: int, iy: int, ix: int,
                      halve: bool, lanes: int = 0) -> np.ndarray:
    """The mean of each ``iy`` x ``ix`` block of the image's top-left
    ``out_h * iy`` x ``out_w * ix`` corner: OpenCV's exact 2x reduction
    (``halve``, ``iy = ix = 2``; integer images ``(sum + 2) >> 2``; float
    images with ``lanes`` ``(a + b) + (c + d)`` on the first ``n - n %
    lanes`` elements of each output row) or its integer-factor area resize
    (float sums four taps at a time, as OpenCV's unrolled loop)."""
    image = _planes(image)
    h, w, c = image.shape
    if min(out_h, out_w, iy, ix) < 1 or out_h * iy > h or out_w * ix > w:
        raise ValueError(f"{out_h}x{out_w} blocks of {iy}x{ix} do not fit a {h}x{w} image")
    if halve and (iy, ix) != (2, 2):
        raise ValueError("halving takes 2x2 blocks")
    if lanes < 0:
        raise ValueError(f"lanes {lanes}")
    out = np.empty((out_h, out_w, c), image.dtype)
    load_image_ops().ssd_resize_block_mean(DTYPES[image.dtype], _ptr(image), w, c, iy, ix,
                                           out_h, out_w, int(bool(halve)), int(lanes), _ptr(out))
    image_ops_calls["resize"] += 1
    return out


def warp_affine(image: np.ndarray, inv, border, out_h: int, out_w: int) -> np.ndarray:
    """OpenCV's INTER_LINEAR affine warp with a constant border, on
    unrounded source positions: ``inv`` is the inverted (2, 3) map and
    ``border`` one value a channel, both in the work type (float64 for
    float64 images, float32 for the others)."""
    image = _planes(image)
    h, w, c = image.shape
    work = _accumulator(image.dtype)
    inv = _table(np.reshape(inv, -1), work, (6,), "inv")
    border = _table(border, work, (c,), "border")
    if out_h < 1 or out_w < 1:
        raise ValueError(f"output size {out_w}x{out_h}")
    out = np.empty((out_h, out_w, c), image.dtype)
    load_image_ops().ssd_warp_affine(DTYPES[image.dtype], _ptr(image), h, w, c, _ptr(inv),
                                     _ptr(border), out_h, out_w, _ptr(out))
    image_ops_calls["warp_affine"] += 1
    return out


def warp_remap(image: np.ndarray, x0, y0, dx, dy, table, cval) -> np.ndarray:
    """OpenCV's remap-path INTER_LINEAR affine warp with a constant border:
    ``x0``/``y0`` (out_h,) and ``dx``/``dy`` (out_w,) are the int32 source
    positions in 1/1024 pixel, ``table`` OpenCV's (1024, 4) bilinear
    weights (int32 for uint8 images, float32 for the others) and ``cval``
    one value a channel in the image's type."""
    image = _planes(image)
    h, w, c = image.shape
    out_h, out_w = np.shape(x0)[0], np.shape(dx)[0]
    if out_h < 1 or out_w < 1:
        raise ValueError(f"output size {out_w}x{out_h}")
    x0, y0 = (_table(t, np.int32, (out_h,), "x0, y0") for t in (x0, y0))
    dx, dy = (_table(t, np.int32, (out_w,), "dx, dy") for t in (dx, dy))
    table = _table(table, np.int32 if image.dtype == np.uint8 else np.float32, (1024, 4), "table")
    cval = _table(cval, image.dtype, (c,), "cval")
    out = np.empty((out_h, out_w, c), image.dtype)
    load_image_ops().ssd_warp_remap(DTYPES[image.dtype], _ptr(image), h, w, c, _ptr(x0),
                                    _ptr(y0), _ptr(dx), _ptr(dy), _ptr(table), _ptr(cval),
                                    out_h, out_w, _ptr(out))
    image_ops_calls["warp_affine"] += 1
    return out


def cvt_color(image: np.ndarray, current: str, to: str, sdiv, hdiv) -> np.ndarray:
    """OpenCV's RGB->HSV, HSV->RGB or RGB->GRAY of an (H, W, 3) uint8 or
    float32 image (RGB->GRAY also uint16); ``sdiv`` and ``hdiv`` are the
    256-entry int64 division tables of the uint8 RGB->HSV. GRAY comes back
    (H, W)."""
    code = _CVT_CODES[(current, to)]
    image = _planes(image, _CVT_DTYPES["GRAY" if to == "GRAY" else "HSV"])
    h, w, c = image.shape
    if c != 3:
        raise ValueError(f"cvt_color takes (H, W, 3) images, got shape {image.shape}")
    sdiv = _table(sdiv, np.int64, (256,), "sdiv")
    hdiv = _table(hdiv, np.int64, (256,), "hdiv")
    out = np.empty((h, w) if to == "GRAY" else (h, w, 3), image.dtype)
    load_image_ops().ssd_cvt_color(code, DTYPES[image.dtype], _ptr(image), h, w, _ptr(sdiv),
                                   _ptr(hdiv), _ptr(out))
    image_ops_calls["cvt_color"] += 1
    return out
