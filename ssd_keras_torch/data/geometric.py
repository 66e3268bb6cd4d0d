"""Geometric transforms, host-side: ``Resize`` without OpenCV.

Port of ``Resize`` from ``ssd_keras_tpu/data/geometric.py``, which resizes
with ``cv2.resize``. The port does not use OpenCV (the machines that run it
need not have it), so :func:`resize_image` computes what ``cv2.resize``
computes, in NumPy:

* ``INTER_LINEAR`` (the default, and the only mode the evaluator and
  ``predict_all_to_json`` use). For uint8 images, OpenCV's fixed-point path:
  source positions ``(d + 0.5) * scale - 0.5`` clamped to the image, 11-bit
  weights ``round((1 - f) * 2048)`` and ``round(f * 2048)``, an integer
  horizontal pass, and the vertical pass of OpenCV's vector code,
  ``((b0 * (S0 >> 4)) >> 16 + (b1 * (S1 >> 4)) >> 16 + 2) >> 2``. OpenCV's
  scalar code rounds the last step another way on some pixels, so the
  result is within one level of ``cv2.resize`` on every pixel and equal on
  almost all (tested against OpenCV where it is installed). An exact 2x
  reduction averages 2x2 blocks, as OpenCV does. Float images interpolate in
  their own precision with the same positions.
* ``INTER_NEAREST``: source index ``floor(d * scale)``, clamped.

OpenCV's integer codes for the modes are kept as module constants. The other
modes (cubic, area, Lanczos) raise ``NotImplementedError``: they come with
the host augmentation chains' slice, as do the other transforms of the JAX
module. Transforms are callables ``(image, labels=None,
return_inverter=False)``; inverters map predicted boxes (rows ``[class,
conf, xmin, ymin, xmax, ymax]``) back to the pre-transform frame.
"""

from __future__ import annotations

import numpy as np

from ssd_keras_torch.data.validation import DEFAULT_LABELS_FORMAT

__all__ = [
    "Resize",
    "resize_image",
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


def _linear_taps(src: int, dst: int):
    """Per output index: the two source indices and OpenCV's float weight
    of the second, ``f``, for a ``src`` -> ``dst`` linear resize."""
    scale = 1.0 / (dst / src)  # OpenCV: scale = 1 / inv_scale, in double
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    low, high = s < 0, s >= src - 1
    f[low | high] = 0.0
    s[low] = 0
    s[high] = src - 1
    return s, np.minimum(s + 1, src - 1), f


def _fixed_weights(f: np.ndarray):
    one = np.float32(_COEF_SCALE)
    w0 = np.rint((np.float32(1.0) - f) * one).astype(np.int32)
    w1 = np.rint(f * one).astype(np.int32)
    return w0, w1


def _linear(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = image.shape[:2]
    x0, x1, fx = _linear_taps(w, out_w)
    y0, y1, fy = _linear_taps(h, out_h)
    if image.dtype == np.uint8:
        a0, a1 = _fixed_weights(fx)
        b0, b1 = _fixed_weights(fy)
        src = image.astype(np.int32)
        rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
        top = (b0[:, None, None] * (rows[y0] >> 4)) >> 16
        bottom = (b1[:, None, None] * (rows[y1] >> 4)) >> 16
        return np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)
    dt = image.dtype
    fx, fy = fx.astype(dt), fy.astype(dt)
    one = dt.type(1.0)
    rows = image[:, x0] * (one - fx)[None, :, None] + image[:, x1] * fx[None, :, None]
    return (rows[y0] * (one - fy)[:, None, None] + rows[y1] * fy[:, None, None]).astype(dt)


def _halve(image: np.ndarray) -> np.ndarray:
    """An exact 2x reduction: the mean of each 2x2 block, as OpenCV's fast
    area resize computes it."""
    h, w = image.shape[0] // 2 * 2, image.shape[1] // 2 * 2
    q = image[:h, :w]
    if image.dtype == np.uint8:
        q = q.astype(np.int32)
        s = q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    quarter = image.dtype.type(0.25)
    return ((q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]) * quarter
            ).astype(image.dtype)


def _nearest(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = image.shape[:2]
    xs = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / w))).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / h))).astype(np.int64), h - 1)
    return image[ys][:, xs]


def resize_image(image: np.ndarray, height: int, width: int,
                 interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(image, (width, height), interpolation=interpolation)``
    for an (H, W) or (H, W, C) uint8 or float image; see the module
    docstring for what is exact. An (H, W, 1) image comes back (h, w), as
    from OpenCV."""
    image = np.asarray(image)
    if interpolation not in (INTER_LINEAR, INTER_NEAREST):
        raise NotImplementedError(
            f"interpolation mode {interpolation} is not ported yet: only INTER_LINEAR and "
            "INTER_NEAREST; the others come with the host augmentation chains' slice")
    if image.dtype != np.uint8 and image.dtype.kind != "f":
        raise NotImplementedError(f"resize of {image.dtype} images is not ported: uint8 or float")
    squeeze = image.ndim == 2 or image.shape[2] == 1
    planes = image.reshape(image.shape[0], image.shape[1], -1)
    if planes.shape[:2] == (height, width):
        out = planes.copy()
    elif interpolation == INTER_NEAREST:
        out = _nearest(planes, height, width)
    elif planes.shape[0] == 2 * height and planes.shape[1] == 2 * width:
        out = _halve(planes)
    else:
        out = _linear(planes, height, width)
    return out[..., 0] if squeeze else out


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
        if interpolation_mode not in (INTER_LINEAR, INTER_NEAREST):
            raise NotImplementedError(
                f"interpolation mode {interpolation_mode} is not ported yet: only INTER_LINEAR "
                "and INTER_NEAREST; the others come with the host augmentation chains' slice")
        self.out_height = height
        self.out_width = width
        self.interpolation_mode = interpolation_mode
        self.box_filter = box_filter
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)

    def __call__(self, image, labels=None, return_inverter=False):
        img_height, img_width = image.shape[:2]
        xmin, ymin, xmax, ymax = _fmt(self.labels_format)

        image = resize_image(image, self.out_height, self.out_width, self.interpolation_mode)

        if return_inverter:
            hs, ws = img_height / self.out_height, img_width / self.out_width

            def inverter(preds):
                preds = np.copy(preds)
                preds[:, [ymin + 1, ymax + 1]] = np.round(preds[:, [ymin + 1, ymax + 1]] * hs)
                preds[:, [xmin + 1, xmax + 1]] = np.round(preds[:, [xmin + 1, xmax + 1]] * ws)
                return preds

        if labels is None:
            return (image, inverter) if return_inverter else image

        labels = np.copy(labels)
        labels[:, [ymin, ymax]] = np.round(labels[:, [ymin, ymax]] * (self.out_height / img_height))
        labels[:, [xmin, xmax]] = np.round(labels[:, [xmin, xmax]] * (self.out_width / img_width))
        if self.box_filter is not None:
            self.box_filter.labels_format = self.labels_format
            labels = self.box_filter(labels, image_height=self.out_height, image_width=self.out_width)
        return (image, labels, inverter) if return_inverter else (image, labels)
