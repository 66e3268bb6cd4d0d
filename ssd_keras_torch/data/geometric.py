"""Geometric augmentation transforms (resize, flip, translate, scale, rotate),
host-side, without OpenCV.

Port of ``ssd_keras_tpu/data/geometric.py``, which resizes with
``cv2.resize`` and warps with ``cv2.warpAffine``. The port does not use
OpenCV (the machines that run it need not have it), so this module computes
what OpenCV 5.0 computes, as its wheels ship it: with Intel IPP, which
``cv2.resize`` hands some cells (a dtype, a mode and 1, 3 or 4 channels) and
whose arithmetic is its own. Python works out each resize's tap indices and
weights; the per-pixel loops run in host C++ (``native.image_ops``, built by
g++ at first use) for uint8, uint16, int16, float32 and float64 images, and
in NumPy for another float type (float16, which OpenCV refuses but for
``INTER_NEAREST``). The NumPy versions, :func:`resize_image_numpy` and
:func:`warp_affine_numpy`, are the plain versions: the C++ equals them bit
for bit, and the tests hold both to OpenCV as follows. Integer images are
rounded half to even and saturated to their type (``saturate_cast``).

:func:`resize_image` (``cv2.resize``), for uint8, uint16, int16 and float
images, and in ``INTER_NEAREST`` also int8, uint32, int32 and bool (int64
and uint64 come back int32, as from ``cv2``'s binding):

* ``INTER_LINEAR``: source positions ``(d + 0.5) * scale - 0.5``; along x a
  position outside the image takes the edge pixel with weight one, along y
  the two rows are clamped but keep their weights (OpenCV resets only x).
  uint8 runs OpenCV's fixed-point path: 11-bit weights, an integer
  horizontal pass and the vertical pass ``((b0 * (S0 >> 4)) >> 16 + (b1 *
  (S1 >> 4)) >> 16 + 2) >> 2``; other types sum in float32 (float64 in
  float64) with float32 weights. An exact 2x reduction averages 2x2 blocks:
  integer images of 1, 3 or 4 channels ``(sum + 2) >> 2``, float32 of 1 or
  4 channels ``(a + b) + (c + d)`` in OpenCV's vector pass.
* ``INTER_NEAREST``: source index ``floor(d * scale)``, clamped. A gather.
* ``INTER_CUBIC``: Keys' cubic with a = -0.75 on four clamped taps. uint8 in
  OpenCV's fixed point (11-bit weights, integer rows) with the vertical sum
  in float32; other types in float32 (float64 in float64). The vertical
  vector pass adds the taps in reverse over each row's first ``n - n %
  lanes`` elements (4 lanes for float32, 8 for the others).
* ``INTER_AREA``: shrinking on both axes averages each output cell's source
  area with OpenCV's weights (integer factors: the block mean, summed four
  taps at a time and scaled by float32 ``1 / area``); enlarging on either
  axis is linear with OpenCV's area-mode positions.
* ``INTER_LANCZOS4``: eight clamped taps; uint8 in 11-bit fixed point, other
  types in float32 (float64 in float64), with the reverse vertical pass for
  float32 and int16.

Against ``cv2`` as shipped: exact in every cell but IPP's, ``INTER_LINEAR``
of uint16, int16, float32 and float64 and ``INTER_CUBIC`` of uint8, uint16,
int16 and float32, at 1, 3 or 4 channels. There integers are within one
level and floats within 2e-3 on values of a 0-255 range. The linear cells
compute OpenCV's own arithmetic (exact with ``cv2.ipp.setUseIPP(False)``);
the cubic cells keep a forward float32 sum, which comes nearest IPP's (uint8
equal on all but about one pixel in ten thousand).

:func:`warp_affine` (``cv2.warpAffine`` with ``INTER_LINEAR`` and a constant
border, the border value saturated to the image's type). OpenCV 5 takes one
of two paths:

* uint8, uint16 and float32 at 1, 3 or 4 channels: its float kernel on
  unrounded source positions. The map is inverted in double and cast to
  float32, the source position is ``fma(M0, x, M1 * y + M2)``, and the pixel
  is two lerps in x and one in y, each a fused multiply-add, over the four
  neighbours (a neighbour outside the image takes the border value).
  Integer translations are exact copies. OpenCV's scalar loop over the last
  ``width % 16`` pixels of a row rounds the position otherwise (the order is
  not known): there a rotation differs by one level (uint16, under one
  pixel in a thousand) or 2e-3 (float32 on a 0-300 range, under one pixel
  in a hundred); uint8 was equal on every fixture.
* float64 and int16 at any channel count, and every type at another count
  (2, 5, ...): the remap path, exact. Source positions in 1/32 pixel
  (``AB_BITS`` 10, ``INTER_BITS`` 5: each row's ``M1 * y + M2`` and each
  column's ``M0 * x`` scaled by 1024 and rounded, plus 16, shifted right by
  5), weights from OpenCV's 32 x 32 bilinear table (15-bit integers for
  uint8, float32 for the others), summed ``v00 w0 + v01 w1 + v10 w2 + v11
  w3``; a pixel whose four neighbours lie outside is the border itself, and
  channel ``k`` takes the border's value ``k & 3``.

A right-angle ``Rotate`` is not ``np.rot90``: OpenCV's result is shifted by
a pixel with a border row or column, and so is this one.

Transforms are callables ``(image, labels=None, return_inverter=False)``;
inverters map predicted boxes (rows ``[class, conf, xmin, ymin, xmax,
ymax]``) back to the pre-transform frame. Labels never depend on pixels and
match the JAX package bit for bit. The random transforms draw from the
global ``np.random`` (and ``RandomRotate`` from Python's ``random``) in the
JAX package's order.
"""

from __future__ import annotations

import math
import random as _pyrandom

import numpy as np

from ssd_keras_torch.data.validation import DEFAULT_LABELS_FORMAT
from ssd_keras_torch.native import image_ops

__all__ = [
    "Resize",
    "ResizeRandomInterp",
    "Flip",
    "RandomFlip",
    "Translate",
    "RandomTranslate",
    "Scale",
    "RandomScale",
    "Rotate",
    "RandomRotate",
    "resize_image",
    "resize_image_numpy",
    "warp_affine",
    "warp_affine_numpy",
    "rotation_matrix_2d",
    "INTER_NEAREST",
    "INTER_LINEAR",
    "INTER_CUBIC",
    "INTER_AREA",
    "INTER_LANCZOS4",
]

# OpenCV's interpolation codes.
INTER_NEAREST = 0
INTER_LINEAR = 1
INTER_CUBIC = 2
INTER_AREA = 3
INTER_LANCZOS4 = 4

_COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE: 11-bit weights
_F32 = np.float32
# The integer types that OpenCV resizes in every mode and warps.
_INTEGER_TYPES = (np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.int16))
# The channel counts of OpenCV's vector paths (its 2x area halving and its
# unrounded warp); another count takes its scalar or remap code.
_VECTOR_CHANNELS = (1, 3, 4)


def _work_type(dtype: np.dtype):
    """The type OpenCV sums a resize or warp of ``dtype`` in: float32 for
    the integer types, a float type's own."""
    return dtype.type if dtype.kind == "f" else _F32


def _store(out: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """``out`` as ``dtype``: integers rounded half to even and saturated
    (OpenCV's ``saturate_cast``)."""
    if dtype.kind == "f":
        return out.astype(dtype)
    info = np.iinfo(dtype)
    return np.clip(np.rint(out), info.min, info.max).astype(dtype)


# --------------------------------------------------------------------------- #
# Linear (and area-mode linear)
# --------------------------------------------------------------------------- #


def _linear_taps(src: int, dst: int, reset: bool):
    """Per output index: the two source indices and OpenCV's float weight
    of the second, ``f``, for a ``src`` -> ``dst`` linear resize. ``reset``
    (the x axis) gives a position outside the image the edge pixel alone."""
    scale = 1.0 / (dst / src)  # OpenCV: scale = 1 / inv_scale, in double
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(_F32)).astype(_F32)
    if reset:
        f[(s < 0) | (s >= src - 1)] = 0.0
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


def _area_linear_taps(src: int, dst: int, reset: bool):
    """The taps of ``INTER_AREA`` when it enlarges: linear, with OpenCV's
    area-mode positions ``s = floor(d * scale)`` and weight
    ``frac((d + 1) - (s + 1) / scale)``."""
    inv = dst / src
    d = np.arange(dst)
    s = np.floor(d * (1.0 / inv)).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(_F32)
    f = np.where(f <= 0, _F32(0.0), (f - np.floor(f)).astype(_F32)).astype(_F32)
    if reset:
        f[s >= src - 1] = 0.0
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


def _fixed_weights(f: np.ndarray):
    one = np.float32(_COEF_SCALE)
    w0 = np.rint((np.float32(1.0) - f) * one).astype(np.int32)
    w1 = np.rint(f * one).astype(np.int32)
    return w0, w1


def linear_taps_u8(src: int, dst: int, reset: bool):
    """The taps of a uint8 ``INTER_LINEAR`` resize of ``src`` to ``dst``
    samples along one axis, as ``_linear`` uses them: the two source
    indices and their 11-bit weights, int32 each. ``reset`` as in
    ``_linear_taps`` (the x axis)."""
    i0, i1, f = _linear_taps(src, dst, reset)
    w0, w1 = _fixed_weights(f)
    return i0.astype(np.int32), i1.astype(np.int32), w0, w1


def routes_to_linear(height: int, width: int, out_height: int, out_width: int) -> bool:
    """Whether :func:`resize_image` in ``INTER_LINEAR`` resizes a ``height``
    x ``width`` image to ``out_height`` x ``out_width`` with ``_linear``:
    not a copy (the same size), not an exact 2x reduction (``_halve``)."""
    return ((height, width) != (out_height, out_width)
            and (height, width) != (2 * out_height, 2 * out_width))


def _linear(image: np.ndarray, xtaps, ytaps, native: bool) -> np.ndarray:
    x0, x1, fx = xtaps
    y0, y1, fy = ytaps
    if image.dtype == np.uint8:
        a0, a1 = _fixed_weights(fx)
        b0, b1 = _fixed_weights(fy)
        if native:
            return image_ops.resize_linear_u8(image, (x0, x1, a0, a1), (y0, y1, b0, b1))
        src = image.astype(np.int32)
        rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
        top = (b0[:, None, None] * (rows[y0] >> 4)) >> 16
        bottom = (b1[:, None, None] * (rows[y1] >> 4)) >> 16
        return np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)
    # The weights 1 - f and f are float32 for every type (OpenCV's).
    dt = _work_type(image.dtype)
    ax = np.stack([_F32(1.0) - fx, fx], 1).astype(dt)
    ay = np.stack([_F32(1.0) - fy, fy], 1).astype(dt)
    if native:
        return image_ops.resize_separable(image, np.stack([x0, x1], 1), ax,
                                          np.stack([y0, y1], 1), ay)
    src = image.astype(dt)
    rows = (src[:, x0] * ax[None, :, 0, None] + src[:, x1] * ax[None, :, 1, None]).astype(dt)
    return _store(rows[y0] * ay[:, 0, None, None] + rows[y1] * ay[:, 1, None, None], image.dtype)


def _halve(image: np.ndarray, native: bool) -> np.ndarray:
    """An exact 2x reduction: the mean of each 2x2 block, as OpenCV's fast
    area resize computes it. Integer images of 1, 3 or 4 channels take its
    vector path, ``(sum + 2) >> 2``; of another count its scalar block
    mean (``_block_mean``)."""
    h, w = image.shape[0] // 2 * 2, image.shape[1] // 2 * 2
    c = image.shape[2]
    if image.dtype.kind in "ui" and c not in _VECTOR_CHANNELS:
        return _block_mean(image, h // 2, w // 2, 2, 2, native)
    # float32 of 1 or 4 channels: OpenCV's vector pass, (a + b) + (c + d),
    # on the first n - n % 4 elements of each output row.
    lanes = 4 if image.dtype == np.float32 and c in (1, 4) else 0
    if native:
        return image_ops.resize_block_mean(image, h // 2, w // 2, 2, 2, halve=True, lanes=lanes)
    q = image[:h, :w]
    if image.dtype.kind in "ui":
        q = q.astype(np.int64)
        s = q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
        return ((s + 2) >> 2).astype(image.dtype)
    quarter = image.dtype.type(0.25)
    out = ((q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]) * quarter
           ).astype(image.dtype)
    if lanes:
        vector = (((q[0::2, 0::2] + q[0::2, 1::2]) + (q[1::2, 0::2] + q[1::2, 1::2])) * quarter
                  ).astype(image.dtype)
        flat, flat_vector = out.reshape(len(out), -1), vector.reshape(len(out), -1)
        vec = flat.shape[1] - flat.shape[1] % lanes
        flat[:, :vec] = flat_vector[:, :vec]
    return out


def _nearest(image: np.ndarray, out_h: int, out_w: int, native: bool) -> np.ndarray:
    h, w = image.shape[:2]
    xs = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / w))).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / h))).astype(np.int64), h - 1)
    if native:
        return image_ops.resize_nearest(image, ys, xs)
    return image[ys][:, xs]


# --------------------------------------------------------------------------- #
# Area (shrinking)
# --------------------------------------------------------------------------- #


def _area_table(src: int, dst: int, scale: float):
    """OpenCV's ``computeResizeAreaTab``: per output cell, its source indices
    and float32 weights, in OpenCV's order, as (dst, taps) arrays padded
    with weight 0."""
    cells = []
    for d in range(dst):
        fs1 = d * scale
        fs2 = fs1 + scale
        width = min(scale, src - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - fs1 > 1e-3:
            taps.append((s1 - 1, (s1 - fs1) / width))
        taps.extend((s, 1.0 / width) for s in range(s1, s2))
        if fs2 - s2 > 1e-3:
            taps.append((s2, min(min(fs2 - s2, 1.0), width) / width))
        cells.append(taps)
    n = max(len(t) for t in cells)
    index = np.zeros((dst, n), np.int64)
    weight = np.zeros((dst, n), _F32)
    for d, taps in enumerate(cells):
        for j, (s, a) in enumerate(taps):
            index[d, j], weight[d, j] = s, a
    return index, weight


def _block_mean(image: np.ndarray, out_h: int, out_w: int, iy: int, ix: int,
                native: bool) -> np.ndarray:
    """OpenCV's integer-factor area resize: the mean of each ``iy`` x ``ix``
    block, uint8 by its int64 sum, other types by the sum in their work
    type from 0, times the float32 ``1 / (ix * iy)``."""
    if native:
        return image_ops.resize_block_mean(image, out_h, out_w, iy, ix, halve=False)
    blocks = image[: out_h * iy, : out_w * ix].reshape(out_h, iy, out_w, ix, -1)
    acc_t = _work_type(image.dtype)
    scale = acc_t(_F32(1.0) / _F32(ix * iy))  # OpenCV's float scale, for float64 too
    if image.dtype == np.uint8:
        total = blocks.astype(np.int64).sum(axis=(1, 3)).astype(_F32)
        return _store(total * scale, image.dtype)
    # OpenCV's unrolled sum: the block's pixels in row order, four at a time
    # added among themselves, then to the total.
    taps = [blocks[:, a, :, b].astype(acc_t) for a in range(iy) for b in range(ix)]
    acc = np.zeros((out_h, out_w, image.shape[2]), acc_t)
    for k in range(0, len(taps) - 3, 4):
        acc = (acc + (((taps[k] + taps[k + 1]) + taps[k + 2]) + taps[k + 3])).astype(acc_t)
    for tap in taps[len(taps) // 4 * 4:]:
        acc = (acc + tap).astype(acc_t)
    return _store(acc * scale, image.dtype)


def _area_shrink(image: np.ndarray, out_h: int, out_w: int, native: bool) -> np.ndarray:
    h, w = image.shape[:2]
    scale_x, scale_y = 1.0 / (out_w / w), 1.0 / (out_h / h)
    ix, iy = int(round(scale_x)), int(round(scale_y))
    eps = np.finfo(np.float64).eps
    if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:  # OpenCV's fast area
        if ix == 2 and iy == 2:
            return _halve(image, native)
        return _block_mean(image, out_h, out_w, iy, ix, native)
    acc_t = _work_type(image.dtype)
    xi, xw = _area_table(w, out_w, scale_x)
    yi, yw = _area_table(h, out_h, scale_y)
    if native:
        return image_ops.resize_separable(image, xi, xw.astype(acc_t), yi, yw.astype(acc_t),
                                          x_from_zero=True)
    src = image.astype(acc_t)
    rows = np.zeros((h, out_w, image.shape[2]), acc_t)
    for j in range(xi.shape[1]):  # OpenCV's order of accumulation
        rows = (rows + src[:, xi[:, j]] * xw[None, :, j, None].astype(acc_t)).astype(acc_t)
    out = (yw[:, 0, None, None].astype(acc_t) * rows[yi[:, 0]]).astype(acc_t)
    for j in range(1, yi.shape[1]):
        out = (out + yw[:, j, None, None].astype(acc_t) * rows[yi[:, j]]).astype(acc_t)
    return _store(out, image.dtype)


# --------------------------------------------------------------------------- #
# Cubic and Lanczos
# --------------------------------------------------------------------------- #


def _cubic_weights(x: np.ndarray) -> np.ndarray:
    """OpenCV's ``interpolateCubic`` (a = -0.75) in float32."""
    a = _F32(-0.75)
    one = _F32(1.0)
    x1 = (x + one).astype(_F32)
    c0 = (((a * x1 - _F32(5.0) * a) * x1 + _F32(8.0) * a) * x1 - _F32(4.0) * a).astype(_F32)
    c1 = (((a + _F32(2.0)) * x - (a + _F32(3.0))) * x * x + one).astype(_F32)
    omx = (one - x).astype(_F32)
    c2 = (((a + _F32(2.0)) * omx - (a + _F32(3.0))) * omx * omx + one).astype(_F32)
    c3 = (one - c0 - c1 - c2).astype(_F32)
    return np.stack([c0, c1, c2, c3], axis=-1)


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = np.array([[1, 0], [-_S45, -_S45], [0, 1], [_S45, -_S45],
                        [-1, 0], [_S45, _S45], [0, -1], [-_S45, _S45]])


def _lanczos4_weights(x: np.ndarray) -> np.ndarray:
    """OpenCV's ``interpolateLanczos4``: sin terms in double, weights in
    float32 normalised by their float32 sum."""
    y0 = -(x + _F32(3.0)).astype(np.float64) * math.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    coeffs = []
    total = np.zeros_like(x, dtype=_F32)
    for i in range(8):
        yi = (x + _F32(3.0) - _F32(i)).astype(_F32)
        y = -yi.astype(np.float64) * math.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            c = ((_LANCZOS_CS[i, 0] * s0 + _LANCZOS_CS[i, 1] * c0) / (y * y)).astype(_F32)
        c = np.where(np.abs(yi) >= _F32(1e-6), c, _F32(1e30)).astype(_F32)
        coeffs.append(c)
        total = (total + c).astype(_F32)
    inv = (_F32(1.0) / total).astype(_F32)
    return np.stack([(c * inv).astype(_F32) for c in coeffs], axis=-1)


def _kernel_taps(src: int, dst: int, ksize: int):
    """Clamped source indices (dst, ksize) and float32 weights for cubic
    (4 taps) or Lanczos (8 taps); positions are never reset at the border."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(_F32)).astype(_F32)
    weights = _cubic_weights(f) if ksize == 4 else _lanczos4_weights(f)
    index = s[:, None] + np.arange(ksize)[None, :] - (ksize // 2 - 1)
    return np.clip(index, 0, src - 1), weights


def _dense(index: np.ndarray, weights: np.ndarray, src: int) -> np.ndarray:
    """The (dst, src) float64 matrix of clamped taps (repeated taps add)."""
    out = np.zeros((index.shape[0], src))
    np.add.at(out, (np.repeat(np.arange(index.shape[0]), index.shape[1]), index.ravel()),
              weights.ravel())
    return out


# cv2.resize hands INTER_CUBIC of these types at 1, 3 or 4 channels to IPP
# (the OpenCV wheels are built with it), whose float arithmetic is its own.
_IPP_CUBIC_TYPES = (np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.int16),
                    np.dtype(np.float32))


def _vector_lanes(dtype: np.dtype, ksize: int, channels: int) -> int:
    """The elements a step of OpenCV's vertical vector pass of a cubic
    (``ksize`` 4) or Lanczos4 (8) resize, which adds the taps in reverse,
    ``s0*b0 + (s1*b1 + (... + s7*b7))``; a row's last ``n % lanes``
    elements take its scalar loop, forward. 0: forward throughout (float64,
    uint16 Lanczos4, and IPP's cubic cells, which the forward sum comes
    nearest)."""
    if ksize == 4 and dtype in _IPP_CUBIC_TYPES and channels in _VECTOR_CHANNELS:
        return 0
    if dtype == np.float32:
        return 4
    if dtype == np.int16 or (ksize == 4 and dtype in (np.uint8, np.uint16)):
        return 8
    return 0


def _vertical(rows: np.ndarray, yi: np.ndarray, yw: np.ndarray, acc_t, lanes: int):
    """The vertical pass of a separable resize in ``acc_t``: forward, or
    reversed on the first ``n - n % lanes`` elements of each output row."""
    out = (rows[yi[:, 0]] * yw[:, 0, None, None]).astype(acc_t)
    for j in range(1, yi.shape[1]):
        out = (out + rows[yi[:, j]] * yw[:, j, None, None]).astype(acc_t)
    if lanes:
        rev = (rows[yi[:, -1]] * yw[:, -1, None, None]).astype(acc_t)
        for j in range(yi.shape[1] - 2, -1, -1):
            rev = (rows[yi[:, j]] * yw[:, j, None, None] + rev).astype(acc_t)
        flat, flat_rev = out.reshape(len(out), -1), rev.reshape(len(out), -1)
        vec = flat.shape[1] - flat.shape[1] % lanes
        flat[:, :vec] = flat_rev[:, :vec]
    return out


def _separable(image: np.ndarray, out_h: int, out_w: int, ksize: int,
               native: bool) -> np.ndarray:
    h, w = image.shape[:2]
    xi, xw = _kernel_taps(w, out_w, ksize)
    yi, yw = _kernel_taps(h, out_h, ksize)
    lanes = _vector_lanes(image.dtype, ksize, image.shape[2])
    if image.dtype == np.uint8 and (ksize == 8 or lanes):
        # OpenCV's fixed point: 11-bit weights, exact integer sums, then
        # (total + (1 << 21)) >> 22, or (cubic) the vertical vector pass in
        # float32 on weights / 2**22, rounded. Every integer sum is below
        # 2**53, so two float64 matrix products give it exactly (the C++
        # sums in int64).
        ax = np.rint(xw * _F32(_COEF_SCALE)).astype(np.int32)
        by = np.rint(yw * _F32(_COEF_SCALE)).astype(np.int32)
        if native:
            return image_ops.resize_fixed_u8(image, xi, ax, yi, by, lanes)
        c = image.shape[2]
        rows = image.astype(np.float64).transpose(0, 2, 1) @ _dense(xi, ax, w).T  # (h, c, out_w)
        rows = rows.transpose(0, 2, 1).reshape(h, out_w * c)
        total = (_dense(yi, by, h) @ rows).astype(np.int64)
        out = np.clip((total + (1 << 21)) >> 22, 0, 255)
        if lanes:
            scale = _F32(1.0 / (_COEF_SCALE * _COEF_SCALE))
            beta = (by.astype(_F32) * scale).astype(_F32)
            vec = _vertical(rows.astype(_F32)[..., None], yi, beta, _F32, lanes)[..., 0]
            n = out.shape[1] - out.shape[1] % lanes
            out[:, :n] = np.clip(np.rint(vec[:, :n]), 0, 255)
        return out.reshape(out_h, out_w, c).astype(np.uint8)
    acc_t = _work_type(image.dtype)
    xw, yw = xw.astype(acc_t), yw.astype(acc_t)
    if native:
        return image_ops.resize_separable(image, xi, xw, yi, yw, lanes=lanes)
    src = image.astype(acc_t)
    rows = (src[:, xi[:, 0]] * xw[None, :, 0, None]).astype(acc_t)
    for j in range(1, ksize):
        rows = (rows + src[:, xi[:, j]] * xw[None, :, j, None]).astype(acc_t)
    return _store(_vertical(rows, yi, yw, acc_t, lanes), image.dtype)


_MODES = (INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_LANCZOS4)
_WIDE_INTEGERS = (np.dtype(np.int64), np.dtype(np.uint64))
# The types OpenCV warps on its remap path at every channel count.
_REMAP_TYPES = (np.dtype(np.int16), np.dtype(np.float64))


def _resize(image: np.ndarray, height: int, width: int, interpolation: int,
            native: bool) -> np.ndarray:
    """``resize_image`` through the native C++ (``native``) or NumPy."""
    if interpolation not in _MODES:
        raise ValueError(f"unknown interpolation mode {interpolation}")
    if interpolation == INTER_NEAREST and image.dtype in _WIDE_INTEGERS:
        image = image.astype(np.int32)  # cv2's binding takes 64-bit integers as int32
    if image.dtype not in _INTEGER_TYPES and image.dtype.kind != "f" and not (
            interpolation == INTER_NEAREST and image.dtype in image_ops.NEAREST_DTYPES):
        raise NotImplementedError(f"resize of {image.dtype} images is not ported: uint8, "
                                  f"uint16, int16 or float (and more types in INTER_NEAREST)")
    squeeze = image.ndim == 2 or image.shape[2] == 1
    planes = image.reshape(image.shape[0], image.shape[1], -1)
    if native:
        planes = np.ascontiguousarray(planes)
    h, w = planes.shape[:2]
    if (h, w) == (height, width):
        out = planes.copy()
    elif interpolation == INTER_NEAREST:
        out = _nearest(planes, height, width, native)
    elif interpolation == INTER_CUBIC:
        out = _separable(planes, height, width, 4, native)
    elif interpolation == INTER_LANCZOS4:
        out = _separable(planes, height, width, 8, native)
    elif interpolation == INTER_AREA and h >= height and w >= width:
        out = _area_shrink(planes, height, width, native)
    elif interpolation == INTER_AREA:
        out = _linear(planes, _area_linear_taps(w, width, True),
                      _area_linear_taps(h, height, False), native)
    elif h == 2 * height and w == 2 * width:
        out = _halve(planes, native)
    else:
        out = _linear(planes, _linear_taps(w, width, True), _linear_taps(h, height, False),
                      native)
    return out[..., 0] if squeeze else out


def resize_image(image: np.ndarray, height: int, width: int,
                 interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(image, (width, height), interpolation=interpolation)``
    for an (H, W) or (H, W, C) image of a type OpenCV takes in that mode;
    see the module docstring for the types and what is exact. An (H, W, 1)
    image comes back (h, w), as from OpenCV. Another type raises
    ``NotImplementedError``.

    uint8, uint16, int16, float32 and float64 images (and in
    ``INTER_NEAREST`` int8, uint32, int32 and bool) go through the host C++
    (``native.image_ops``); another float type (float16) through NumPy
    (:func:`resize_image_numpy`). Both give the same result; a failed g++
    build raises."""
    image = np.asarray(image)
    native = image.dtype in (image_ops.NEAREST_DTYPES if interpolation == INTER_NEAREST
                             else image_ops.DTYPES)
    return _resize(image, height, width, interpolation, native)


def resize_image_numpy(image: np.ndarray, height: int, width: int,
                       interpolation: int = INTER_LINEAR) -> np.ndarray:
    """:func:`resize_image` in NumPy alone: the plain version the native
    C++ is held to, bit for bit."""
    return _resize(np.asarray(image), height, width, interpolation, False)


# --------------------------------------------------------------------------- #
# Affine warp
# --------------------------------------------------------------------------- #


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: a (2, 3) float64 map rotating by
    ``angle`` degrees counter-clockwise about ``center`` (taken as float32,
    as OpenCV's ``Point2f``) and scaling by ``scale``."""
    cx, cy = float(np.float32(center[0])), float(np.float32(center[1]))
    radians = angle * (math.pi / 180)
    alpha = math.cos(radians) * scale
    beta = math.sin(radians) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m) -> np.ndarray:
    """OpenCV's inversion of a (2, 3) map, in double."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * det, m[0] * det
    m[0] = a11
    m[1] *= -det
    m[3] *= -det
    m[4] = a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _fma(a, b, c, dtype):
    """``a * b + c`` in float64, rounded to ``dtype`` at the end (float32:
    the product of two float32 values is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + c).astype(dtype)


# OpenCV's warpAffine fixed point: AB_BITS, INTER_BITS, INTER_TAB_SIZE.
_AB_BITS = 10
_INTER_BITS = 5
_TAB = 1 << _INTER_BITS
_REMAP_COEF_SCALE = 1 << 15  # INTER_REMAP_COEF_SCALE: the uint8 table's 15-bit weights


def _bilinear_table(fixed: bool) -> np.ndarray:
    """OpenCV's (32 * 32, 4) bilinear weights of the remap path, row
    ``fy * 32 + fx`` for the fractions ``fy / 32`` and ``fx / 32``: float32
    products of ``1 - f`` and ``f`` (exact), or for uint8 those times 2**15
    as int32. OpenCV saturates the origin's 32768 to 32767 and adds 1 to
    its last weight; no uint8 sum tells the two apart."""
    f = np.arange(_TAB, dtype=_F32) * _F32(1.0 / _TAB)
    one = np.stack([_F32(1.0) - f, f], -1)  # (32, 2): 1 - f, f
    tab = (one[:, None, :, None] * one[None, :, None, :]).reshape(_TAB * _TAB, 4)
    return (tab * _REMAP_COEF_SCALE).astype(np.int32) if fixed else tab.astype(_F32)


_BILINEAR = {True: _bilinear_table(True), False: _bilinear_table(False)}


def _cv_round_i32(v: np.ndarray) -> np.ndarray:
    """OpenCV's ``saturate_cast<int>`` of a double: rounded half to even;
    a value outside int32 (or NaN) gives INT_MIN, as the SSE conversion."""
    v = np.asarray(v, np.float64)
    ok = np.abs(v) < 2.0 ** 31
    return np.where(ok, np.rint(np.where(ok, v, 0.0)), -(2.0 ** 31)).astype(np.int64).astype(np.int32)


def _remap_positions(inv: np.ndarray, out_h: int, out_w: int):
    """warpAffine's source positions in 1/1024 pixel: each output row's
    start plus the round delta (x0, y0) and each column's step (dx, dy),
    int32, as OpenCV computes them in double."""
    scale = float(1 << _AB_BITS)
    delta = (1 << _AB_BITS) // _TAB // 2
    xs, ys = np.arange(out_w, dtype=np.float64), np.arange(out_h, dtype=np.float64)
    dx, dy = _cv_round_i32(inv[0] * xs * scale), _cv_round_i32(inv[3] * xs * scale)
    x0 = _cv_round_i32((inv[1] * ys + inv[2]) * scale).astype(np.int64) + delta
    y0 = _cv_round_i32((inv[4] * ys + inv[5]) * scale).astype(np.int64) + delta
    return x0.astype(np.int32), y0.astype(np.int32), dx, dy


def _remap_cval(border: np.ndarray, dtype: np.dtype, c: int) -> np.ndarray:
    """The remap path's border: OpenCV's 4-value scalar, channel ``k``
    taking value ``k & 3``, saturated to the image's type."""
    values = border[np.arange(c) & 3]
    return values.astype(dtype) if dtype.kind == "f" else _store(values, dtype)


def _warp_remap(planes: np.ndarray, inv: np.ndarray, out_h: int, out_w: int,
                border: np.ndarray, native: bool) -> np.ndarray:
    """OpenCV's remap-path warp (see ``warp_affine``): positions in 1/32
    pixel, weights from its 32 x 32 table."""
    h, w, c = planes.shape
    dtype = planes.dtype
    x0, y0, dx, dy = _remap_positions(inv, out_h, out_w)
    table = _BILINEAR[dtype == np.uint8]
    cval = _remap_cval(border, dtype, c)
    if native:
        return image_ops.warp_remap(np.ascontiguousarray(planes), x0, y0, dx, dy, table, cval)

    def wrap32(v):
        return ((v.astype(np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31) >> (_AB_BITS - _INTER_BITS)

    xx = wrap32(x0[:, None].astype(np.int64) + dx[None, :])
    yy = wrap32(y0[:, None].astype(np.int64) + dy[None, :])
    sx = np.clip(xx >> _INTER_BITS, -32768, 32767)
    sy = np.clip(yy >> _INTER_BITS, -32768, 32767)
    weights = table[(yy & (_TAB - 1)) * _TAB + (xx & (_TAB - 1))]
    work = np.int64 if dtype == np.uint8 else (np.float64 if dtype == np.float64 else _F32)

    def pixel(py, px):
        inside = (py >= 0) & (py < h) & (px >= 0) & (px < w)
        value = planes[np.clip(py, 0, h - 1), np.clip(px, 0, w - 1)]
        return np.where(inside[..., None], value, cval).astype(work)

    total = None
    for n, (py, px) in enumerate(((sy, sx), (sy, sx + 1), (sy + 1, sx), (sy + 1, sx + 1))):
        term = (pixel(py, px) * weights[..., n, None].astype(work)).astype(work)
        total = term if total is None else (total + term).astype(work)
    if dtype == np.uint8:
        out = np.clip((total + (1 << 14)) >> 15, 0, 255).astype(np.uint8)
    else:
        out = _store(total, dtype)
    outside = (sx >= w) | (sx + 1 < 0) | (sy >= h) | (sy + 1 < 0)
    return np.where(outside[..., None], cval, out)


def _warp(image: np.ndarray, m, dsize, border_value, native: bool) -> np.ndarray:
    """``warp_affine`` through the native C++ (``native``) or NumPy."""
    if image.dtype not in _INTEGER_TYPES and image.dtype.kind != "f":
        raise NotImplementedError(f"warp of {image.dtype} images is not ported: uint8, uint16, "
                                  f"int16 or float")
    squeeze = image.ndim == 2 or image.shape[2] == 1  # OpenCV returns (h, w)
    planes = image.reshape(image.shape[0], image.shape[1], -1)
    h, w, c = planes.shape
    out_w, out_h = int(dsize[0]), int(dsize[1])
    # OpenCV's border is a 4-value scalar padded with zeros.
    values = np.atleast_1d(np.asarray(border_value, np.float64))
    border = np.zeros(max(c, 4), np.float64)
    border[: values.size] = values
    if image.dtype in _REMAP_TYPES or (c not in _VECTOR_CHANNELS
                                       and image.dtype in image_ops.DTYPES):
        out = _warp_remap(planes, _invert_affine(m), out_h, out_w, border[:4], native)
        return out[..., 0] if squeeze else out
    work = _work_type(image.dtype)
    inv = _invert_affine(m).astype(work)
    # Saturated to the image's type first, as OpenCV's.
    border = _store(border[:c], image.dtype).astype(work)
    if native:
        out = image_ops.warp_affine(np.ascontiguousarray(planes), inv, border, out_h, out_w)
        return out[..., 0] if squeeze else out
    xs = np.arange(out_w, dtype=work)[None, :]
    ys = np.arange(out_h, dtype=work)[:, None]
    x = _fma(inv[0], xs, (inv[1] * ys + inv[2]).astype(work), work)
    y = _fma(inv[3], xs, (inv[4] * ys + inv[5]).astype(work), work)
    sx = np.floor(x).astype(np.int64)
    sy = np.floor(y).astype(np.int64)
    ax = (x - sx).astype(work)[..., None]
    ay = (y - sy).astype(work)[..., None]
    src = planes.astype(work)

    def pixel(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        value = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], value, border).astype(work)

    p00, p01 = pixel(sy, sx), pixel(sy, sx + 1)
    p10, p11 = pixel(sy + 1, sx), pixel(sy + 1, sx + 1)
    top = _fma(ax, (p01 - p00).astype(work), p00, work)
    bottom = _fma(ax, (p11 - p10).astype(work), p10, work)
    out = _store(_fma(ay, (bottom - top).astype(work), top, work), image.dtype)
    return out[..., 0] if squeeze else out


def warp_affine(image: np.ndarray, m, dsize, border_value=0) -> np.ndarray:
    """``cv2.warpAffine(image, m, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=border_value)`` for an (H, W) or
    (H, W, C) uint8, uint16, int16 or float image; ``dsize`` is (width,
    height), as in OpenCV. See the module docstring for OpenCV's two paths
    and what is exact. Another type raises ``NotImplementedError``.

    uint8, uint16, int16, float32 and float64 images go through the host
    C++ (``native.image_ops``); another float type (float16, always on the
    unrounded path) through NumPy (:func:`warp_affine_numpy`). Both give the
    same result; a failed g++ build raises."""
    image = np.asarray(image)
    return _warp(image, m, dsize, border_value, image.dtype in image_ops.DTYPES)


def warp_affine_numpy(image: np.ndarray, m, dsize, border_value=0) -> np.ndarray:
    """:func:`warp_affine` in NumPy alone: the plain version the native C++
    is held to, bit for bit."""
    return _warp(np.asarray(image), m, dsize, border_value, False)


# --------------------------------------------------------------------------- #
# Transforms
# --------------------------------------------------------------------------- #


def _fmt(labels_format):
    fx = labels_format
    return fx["xmin"], fx["ymin"], fx["xmax"], fx["ymax"]


class Resize:
    """Resize to a fixed (height, width); rescales and optionally filters boxes."""

    def __init__(
        self,
        height,
        width,
        interpolation_mode=INTER_LINEAR,
        box_filter=None,
        labels_format=None,
    ):
        if interpolation_mode not in _MODES:
            raise ValueError(f"unknown interpolation mode {interpolation_mode}")
        self.out_height = height
        self.out_width = width
        self.interpolation_mode = interpolation_mode
        self.box_filter = box_filter
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)

    def __call__(self, image, labels=None, return_inverter=False):
        img_height, img_width = image.shape[:2]
        image = resize_image(image, self.out_height, self.out_width, self.interpolation_mode)
        labels, inverter = self.labels_and_inverter(img_height, img_width, labels)
        if labels is None:
            return (image, inverter) if return_inverter else image
        return (image, labels, inverter) if return_inverter else (image, labels)

    def labels_and_inverter(self, img_height, img_width, labels=None):
        """What resizing an ``img_height`` x ``img_width`` image does to its
        ``labels`` (None stays None) and the inverter that maps predictions
        back: ``(labels, inverter)``. The card's resize path
        (``data/datasets.py``) calls it for the images it resizes."""
        xmin, ymin, xmax, ymax = _fmt(self.labels_format)
        hs, ws = img_height / self.out_height, img_width / self.out_width

        def inverter(preds):
            preds = np.copy(preds)
            preds[:, [ymin + 1, ymax + 1]] = np.round(preds[:, [ymin + 1, ymax + 1]] * hs)
            preds[:, [xmin + 1, xmax + 1]] = np.round(preds[:, [xmin + 1, xmax + 1]] * ws)
            return preds

        if labels is None:
            return None, inverter
        labels = np.copy(labels)
        labels[:, [ymin, ymax]] = np.round(labels[:, [ymin, ymax]] * (self.out_height / img_height))
        labels[:, [xmin, xmax]] = np.round(labels[:, [xmin, xmax]] * (self.out_width / img_width))
        if self.box_filter is not None:
            self.box_filter.labels_format = self.labels_format
            labels = self.box_filter(labels, image_height=self.out_height, image_width=self.out_width)
        return labels, inverter


class ResizeRandomInterp:
    """Resize with a randomly chosen OpenCV interpolation mode."""

    DEFAULT_MODES = (
        INTER_NEAREST,
        INTER_LINEAR,
        INTER_CUBIC,
        INTER_AREA,
        INTER_LANCZOS4,
    )

    def __init__(self, height, width, interpolation_modes=None, box_filter=None, labels_format=None):
        self.interpolation_modes = list(interpolation_modes or self.DEFAULT_MODES)
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.resize = Resize(height, width, box_filter=box_filter, labels_format=self.labels_format)

    def __call__(self, image, labels=None, return_inverter=False):
        self.resize.interpolation_mode = np.random.choice(self.interpolation_modes)
        self.resize.labels_format = self.labels_format
        return self.resize(image, labels, return_inverter)


class Flip:
    """Deterministic horizontal or vertical mirror."""

    def __init__(self, dim="horizontal", labels_format=None):
        if dim not in ("horizontal", "vertical"):
            raise ValueError("`dim` must be 'horizontal' or 'vertical'.")
        self.dim = dim
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)

    def __call__(self, image, labels=None, return_inverter=False):
        img_height, img_width = image.shape[:2]
        xmin, ymin, xmax, ymax = _fmt(self.labels_format)
        if self.dim == "horizontal":
            image = image[:, ::-1]
            if labels is None:
                return image
            labels = np.copy(labels)
            labels[:, [xmin, xmax]] = img_width - labels[:, [xmax, xmin]]
        else:
            image = image[::-1]
            if labels is None:
                return image
            labels = np.copy(labels)
            labels[:, [ymin, ymax]] = img_height - labels[:, [ymax, ymin]]
        return image, labels


class RandomFlip:
    def __init__(self, dim="horizontal", prob=0.5, labels_format=None):
        self.dim = dim
        self.prob = prob
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.flip = Flip(dim=dim, labels_format=self.labels_format)

    def __call__(self, image, labels=None):
        if np.random.uniform(0, 1) >= (1.0 - self.prob):
            self.flip.labels_format = self.labels_format
            return self.flip(image, labels)
        return image if labels is None else (image, labels)


class Translate:
    """Shift an image by (dy, dx) image-size fractions; constant background."""

    def __init__(self, dy, dx, clip_boxes=True, box_filter=None, background=(0, 0, 0), labels_format=None):
        self.dy_rel = dy
        self.dx_rel = dx
        self.clip_boxes = clip_boxes
        self.box_filter = box_filter
        self.background = background
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)

    def __call__(self, image, labels=None):
        img_height, img_width = image.shape[:2]
        dy_abs = int(round(img_height * self.dy_rel))
        dx_abs = int(round(img_width * self.dx_rel))
        M = np.float32([[1, 0, dx_abs], [0, 1, dy_abs]])
        image = warp_affine(image, M, (img_width, img_height), self.background)
        if labels is None:
            return image
        xmin, ymin, xmax, ymax = _fmt(self.labels_format)
        labels = np.copy(labels)
        labels[:, [xmin, xmax]] += dx_abs
        labels[:, [ymin, ymax]] += dy_abs
        if self.box_filter is not None:
            self.box_filter.labels_format = self.labels_format
            labels = self.box_filter(labels, image_height=img_height, image_width=img_width)
        if self.clip_boxes:
            labels[:, [ymin, ymax]] = np.clip(labels[:, [ymin, ymax]], 0, img_height - 1)
            labels[:, [xmin, xmax]] = np.clip(labels[:, [xmin, xmax]], 0, img_width - 1)
        return image, labels


class _TrialBased:
    """The retry loop shared by RandomTranslate and RandomScale.

    Draws candidate transform parameters up to ``n_trials_max`` times,
    accepting the first whose transformed boxes pass the image validator;
    falls back to the unaltered input.
    """

    def __call__(self, image, labels=None):
        if np.random.uniform(0, 1) < (1.0 - self.prob):
            return image if labels is None else (image, labels)

        img_height, img_width = image.shape[:2]
        if self.image_validator is not None:
            self.image_validator.labels_format = self.labels_format
        self._op.labels_format = self.labels_format

        for _ in range(max(1, self.n_trials_max)):
            self._draw(img_height, img_width)
            if labels is None or self.image_validator is None:
                return self._op(image, labels)
            candidate = self._transform_labels(labels, img_height, img_width)
            if self.image_validator(candidate, image_height=img_height, image_width=img_width):
                return self._op(image, labels)
        return image if labels is None else (image, labels)


class RandomTranslate(_TrialBased):
    def __init__(
        self,
        dy_minmax=(0.03, 0.3),
        dx_minmax=(0.03, 0.3),
        prob=0.5,
        clip_boxes=True,
        box_filter=None,
        image_validator=None,
        n_trials_max=3,
        background=(0, 0, 0),
        labels_format=None,
    ):
        if dy_minmax[0] > dy_minmax[1] or dx_minmax[0] > dx_minmax[1]:
            raise ValueError("min must not exceed max in dy_minmax/dx_minmax.")
        if dy_minmax[0] < 0 or dx_minmax[0] < 0:
            raise ValueError("dy_minmax/dx_minmax must be non-negative.")
        self.dy_minmax = dy_minmax
        self.dx_minmax = dx_minmax
        self.prob = prob
        self.image_validator = image_validator
        self.n_trials_max = n_trials_max
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self._op = Translate(
            dy=0, dx=0, clip_boxes=clip_boxes, box_filter=box_filter,
            background=background, labels_format=self.labels_format,
        )

    def _draw(self, img_height, img_width):
        dy_abs = np.random.uniform(self.dy_minmax[0], self.dy_minmax[1])
        dx_abs = np.random.uniform(self.dx_minmax[0], self.dx_minmax[1])
        self._op.dy_rel = np.random.choice([-dy_abs, dy_abs])
        self._op.dx_rel = np.random.choice([-dx_abs, dx_abs])

    def _transform_labels(self, labels, img_height, img_width):
        xmin, ymin, xmax, ymax = _fmt(self.labels_format)
        out = np.copy(labels)
        out[:, [ymin, ymax]] += int(round(img_height * self._op.dy_rel))
        out[:, [xmin, xmax]] += int(round(img_width * self._op.dx_rel))
        return out


class Scale:
    """Zoom in/out about the image center; box corners follow the affine map."""

    def __init__(self, factor, clip_boxes=True, box_filter=None, background=(0, 0, 0), labels_format=None):
        if factor <= 0:
            raise ValueError("`factor` must be > 0.")
        self.factor = factor
        self.clip_boxes = clip_boxes
        self.box_filter = box_filter
        self.background = background
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)

    def __call__(self, image, labels=None):
        img_height, img_width = image.shape[:2]
        M = rotation_matrix_2d((img_width / 2, img_height / 2), 0, self.factor)
        image = warp_affine(image, M, (img_width, img_height), self.background)
        if labels is None:
            return image
        xmin, ymin, xmax, ymax = _fmt(self.labels_format)
        labels = np.copy(labels)
        labels = _affine_corners(labels, M, xmin, ymin, xmax, ymax)
        if self.box_filter is not None:
            self.box_filter.labels_format = self.labels_format
            labels = self.box_filter(labels, image_height=img_height, image_width=img_width)
        if self.clip_boxes:
            labels[:, [ymin, ymax]] = np.clip(labels[:, [ymin, ymax]], 0, img_height - 1)
            labels[:, [xmin, xmax]] = np.clip(labels[:, [xmin, xmax]], 0, img_width - 1)
        return image, labels


def _affine_corners(labels, M, xmin, ymin, xmax, ymax):
    """Map the (xmin,ymin) and (xmax,ymax) corners of each box through M."""
    n = labels.shape[0]
    tl = np.stack([labels[:, xmin], labels[:, ymin], np.ones(n)])
    br = np.stack([labels[:, xmax], labels[:, ymax], np.ones(n)])
    labels[:, [xmin, ymin]] = np.round(M @ tl).T.astype(np.int64)
    labels[:, [xmax, ymax]] = np.round(M @ br).T.astype(np.int64)
    return labels


class RandomScale(_TrialBased):
    def __init__(
        self,
        min_factor=0.5,
        max_factor=1.5,
        prob=0.5,
        clip_boxes=True,
        box_filter=None,
        image_validator=None,
        n_trials_max=3,
        background=(0, 0, 0),
        labels_format=None,
    ):
        if not 0 < min_factor <= max_factor:
            raise ValueError("It must be 0 < min_factor <= max_factor.")
        self.min_factor = min_factor
        self.max_factor = max_factor
        self.prob = prob
        self.image_validator = image_validator
        self.n_trials_max = n_trials_max
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self._op = Scale(
            factor=1.0, clip_boxes=clip_boxes, box_filter=box_filter,
            background=background, labels_format=self.labels_format,
        )
        self._img_hw = None

    def _draw(self, img_height, img_width):
        self._op.factor = np.random.uniform(self.min_factor, self.max_factor)
        self._img_hw = (img_height, img_width)

    def _transform_labels(self, labels, img_height, img_width):
        xmin, ymin, xmax, ymax = _fmt(self.labels_format)
        M = rotation_matrix_2d((img_width / 2, img_height / 2), 0, self._op.factor)
        return _affine_corners(np.copy(labels), M, xmin, ymin, xmax, ymax)


class Rotate:
    """Rotate counter-clockwise by 90/180/270 degrees (dims swap for 90/270)."""

    def __init__(self, angle, labels_format=None):
        if angle not in (90, 180, 270):
            raise ValueError("`angle` must be one of 90, 180, 270.")
        self.angle = angle
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)

    def __call__(self, image, labels=None):
        img_height, img_width = image.shape[:2]
        M = rotation_matrix_2d((img_width / 2, img_height / 2), self.angle, 1)
        cos_a, sin_a = np.abs(M[0, 0]), np.abs(M[0, 1])
        new_w = int(img_height * sin_a + img_width * cos_a)
        new_h = int(img_height * cos_a + img_width * sin_a)
        M[1, 2] += (new_h - img_height) / 2
        M[0, 2] += (new_w - img_width) / 2
        image = warp_affine(image, M, (new_w, new_h))
        if labels is None:
            return image
        xmin, ymin, xmax, ymax = _fmt(self.labels_format)
        labels = _affine_corners(np.copy(labels), M, xmin, ymin, xmax, ymax)
        # The affine map moves corners; restore min<max ordering per axis.
        if self.angle in (90, 180):
            labels[:, [ymax, ymin]] = labels[:, [ymin, ymax]]
        if self.angle in (180, 270):
            labels[:, [xmax, xmin]] = labels[:, [xmin, xmax]]
        return image, labels


class RandomRotate:
    def __init__(self, angles=(90, 180, 270), prob=0.5, labels_format=None):
        for angle in angles:
            if angle not in (90, 180, 270):
                raise ValueError("`angles` may only contain 90, 180, 270.")
        self.angles = list(angles)
        self.prob = prob
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.rotate = Rotate(angle=90, labels_format=self.labels_format)

    def __call__(self, image, labels=None):
        if np.random.uniform(0, 1) >= (1.0 - self.prob):
            self.rotate.angle = _pyrandom.choice(self.angles)
            self.rotate.labels_format = self.labels_format
            return self.rotate(image, labels)
        return image if labels is None else (image, labels)
