"""Photometric (color-space) augmentation transforms, host-side, without OpenCV.

Port of ``ssd_keras_tpu/data/photometric.py``. Every transform is a callable
``(image, labels=None) -> (image, labels)``; the ``Random*`` variants apply
their deterministic core with probability ``prob`` and draw from the global
``np.random`` in the JAX package's order (the draw ``p >= 1 - prob`` first,
then the parameter), so that one seed gives one sequence on both sides.

The JAX package calls OpenCV for four operations; the port does not use
OpenCV (the machines that run it need not have it), so this module computes
what OpenCV 5 computes. :func:`cvt_color` runs in host C++
(``native.image_ops``, built by g++ at first use), equal bit for bit to its
plain NumPy version :func:`cvt_color_numpy`; the LUT and ``equalize_hist``
are NumPy:

* :func:`cvt_color` ``RGB->HSV`` on uint8: OpenCV's integer path, with H in
  [0, 180) and its 12-bit fixed-point division tables. Exact.
* ``HSV->RGB`` on uint8: OpenCV's float path (sector, fraction, the ``1 -
  s*f`` terms as fused multiply-adds), truncated to uint8 in its vector loop
  (blocks of 32 pixels, as OpenCV's AVX2 build runs it) and rounded in its
  scalar loop (the last ``width % 32`` pixels of each row). Exact over every
  (H, S, V) triple, H up to 255 included, in either loop.
* ``RGB->GRAY`` on uint8 and uint16: ``(R*9798 + G*19235 + B*3735 + (1 <<
  14)) >> 15``. Exact.
* The float32 forms of the three (H in degrees [0, 360), S in [0, 1]; gray
  ``0.299 R + 0.587 G + 0.114 B``): within a few float32 ulps of OpenCV.
* ``cv2.LUT`` is ``table[image]``; ``cv2.equalizeHist`` is the cumulative
  histogram LUT with the scale ``255 / (total - count of the first nonzero
  bin)`` in float32, rounded half to even. Both exact.

The tests hold each against OpenCV where it is installed.
"""

from __future__ import annotations

import numpy as np

from ssd_keras_torch.data.geometric import _fma
from ssd_keras_torch.native import image_ops

__all__ = [
    "ConvertColor",
    "ConvertDataType",
    "ConvertTo3Channels",
    "Hue",
    "RandomHue",
    "Saturation",
    "RandomSaturation",
    "Brightness",
    "RandomBrightness",
    "Contrast",
    "RandomContrast",
    "Gamma",
    "RandomGamma",
    "HistogramEqualization",
    "RandomHistogramEqualization",
    "ChannelSwap",
    "RandomChannelSwap",
    "cvt_color",
    "cvt_color_numpy",
    "equalize_hist",
]

_F32 = np.float32
_HSV_SHIFT = 12  # OpenCV's hsv_shift


def _division_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV = _division_tables()
# Which of (v, p, q, t) is (b, g, r) in each 60-degree sector.
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _rgb_to_hsv_u8(image: np.ndarray) -> np.ndarray:
    x = image.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _rgb_to_hsv_f32(image: np.ndarray) -> np.ndarray:
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    eps = np.finfo(_F32).eps
    v = np.maximum(np.maximum(r, g), b)
    diff = (v - np.minimum(np.minimum(r, g), b)).astype(_F32)
    s = (diff / (np.abs(v) + eps)).astype(_F32)
    d = (_F32(60.0) / (diff + eps)).astype(_F32)
    h = np.where(v == r, (g - b) * d,
                 np.where(v == g, (b - r) * d + _F32(120.0), (r - g) * d + _F32(240.0)))
    h = np.where(h < 0, h + _F32(360.0), h).astype(_F32)
    return np.stack([h, s, v], axis=-1).astype(_F32)


def _hsv_sectors(h: np.ndarray, s: np.ndarray, v: np.ndarray, hscale, fused: bool):
    """(r, g, b) from H scaled into sextants, S and V, as OpenCV's HSV2RGB."""
    hh = (h * _F32(hscale)).astype(_F32)
    pre = np.trunc(hh)
    frac = (hh - pre).astype(_F32)
    sector = (pre - np.trunc(pre * _F32(1.0 / 6.0)) * 6).astype(np.int64) % 6
    one = _F32(1.0)
    p = (v * (one - s)).astype(_F32)
    if fused:
        q = (v * _fma(-s, frac, 1.0, _F32)).astype(_F32)
        t = (v * _fma(-s, (one - frac).astype(_F32), 1.0, _F32)).astype(_F32)
    else:
        q = (v * (one - s * frac)).astype(_F32)
        t = (v * (one - s * (one - frac))).astype(_F32)
    tab = np.stack([v, p, q, t], axis=-1)
    bgr = np.take_along_axis(tab, _SECTOR[sector], axis=-1)
    return bgr[..., ::-1]


_HSV_BLOCK = 32  # pixels per step of OpenCV's vector HSV2RGB (four 8-lane vectors)


def _hsv_to_rgb_u8(image: np.ndarray) -> np.ndarray:
    scale = _F32(1.0 / 255.0)
    h = image[..., 0].astype(_F32)
    s = (image[..., 1].astype(_F32) * scale).astype(_F32)
    v = (image[..., 2].astype(_F32) * scale).astype(_F32)
    rgb = (_hsv_sectors(h, s, v, 6.0 / 180.0, fused=True) * _F32(255.0)).astype(_F32)
    # The vector loop truncates; the last width % 32 pixels of each row go
    # through OpenCV's scalar loop, which rounds.
    out = np.floor(rgb)
    tail = image.shape[1] - image.shape[1] % _HSV_BLOCK
    out[:, tail:] = np.rint(rgb[:, tail:])
    return out.astype(np.uint8)


def _hsv_to_rgb_f32(image: np.ndarray) -> np.ndarray:
    return _hsv_sectors(image[..., 0], image[..., 1], image[..., 2], 6.0 / 360.0,
                        fused=False).astype(_F32)


def _rgb_to_gray(image: np.ndarray) -> np.ndarray:
    if image.dtype.kind == "u":  # uint8 and uint16: OpenCV's 15-bit weights
        x = image.astype(np.int64)
        return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + (1 << 14))
                >> 15).astype(image.dtype)
    return (image[..., 0] * _F32(0.299) + image[..., 1] * _F32(0.587)
            + image[..., 2] * _F32(0.114)).astype(_F32)


_CONVERSIONS = {
    ("RGB", "HSV"): (_rgb_to_hsv_u8, _rgb_to_hsv_f32),
    ("HSV", "RGB"): (_hsv_to_rgb_u8, _hsv_to_rgb_f32),
    ("RGB", "GRAY"): (_rgb_to_gray, _rgb_to_gray),
}


def _checked(image, to: str) -> np.ndarray:
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.float32) and not (to == "GRAY" and image.dtype == np.uint16):
        raise TypeError(f"cvt_color takes uint8 or float32 images (RGB->GRAY also uint16), "
                        f"got {image.dtype}")
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"cvt_color takes (H, W, 3) images, got shape {image.shape}")
    return image


def cvt_color(image: np.ndarray, current: str, to: str) -> np.ndarray:
    """``cv2.cvtColor`` between RGB, HSV and GRAY for an (H, W, 3) uint8 or
    float32 image, and RGB->GRAY of a uint16 one (see the module docstring
    for the ranges and what is exact), through the host C++
    (``native.image_ops``). Equal bit for bit
    to :func:`cvt_color_numpy`; a failed g++ build raises."""
    image = _checked(image, to)
    return image_ops.cvt_color(np.ascontiguousarray(image), current, to, _SDIV, _HDIV)


def cvt_color_numpy(image: np.ndarray, current: str, to: str) -> np.ndarray:
    """:func:`cvt_color` in NumPy alone: the plain version the native C++
    is held to, bit for bit."""
    image = _checked(image, to)
    integer, f32 = _CONVERSIONS[(current, to)]
    return f32(image) if image.dtype == np.float32 else integer(image)


def equalize_hist(channel: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist`` of a uint8 (H, W) channel."""
    channel = np.asarray(channel)
    if channel.dtype != np.uint8:
        raise TypeError(f"equalize_hist takes a uint8 channel, got {channel.dtype}")
    hist = np.bincount(channel.ravel(), minlength=256)
    first = int(np.argmax(hist > 0))
    total = channel.size
    if hist[first] == total:
        return np.full_like(channel, first)
    scale = _F32(255.0) / _F32(total - hist[first])
    cumulative = np.cumsum(hist) - hist[first]
    lut = np.clip(np.rint((cumulative.astype(_F32) * scale).astype(_F32)), 0, 255)
    lut[: first + 1] = 0
    return lut.astype(np.uint8)[channel]


def _ret(image, labels):
    return image if labels is None else (image, labels)


class _Probabilistic:
    """Mixin: apply ``self._apply`` with probability ``self.prob``."""

    prob = 0.5

    def __call__(self, image, labels=None):
        if np.random.uniform(0, 1) >= (1.0 - self.prob):
            self._draw()
            return _ret(*self._split(self._apply(image), labels))
        return _ret(image, labels)

    def _split(self, image, labels):
        return image, labels

    def _draw(self):
        pass


class ConvertColor:
    """RGB <-> HSV <-> GRAY conversion (:func:`cvt_color`)."""

    def __init__(self, current="RGB", to="HSV", keep_3ch=True):
        if current not in ("RGB", "HSV") or to not in ("RGB", "HSV", "GRAY"):
            raise NotImplementedError(f"Unsupported conversion {current}->{to}.")
        self.current, self.to, self.keep_3ch = current, to, keep_3ch

    def __call__(self, image, labels=None):
        if self.current == "HSV" and self.to == "GRAY":
            image = cvt_color(image, "HSV", "RGB")
            image = cvt_color(image, "RGB", "GRAY")
        elif (self.current, self.to) in _CONVERSIONS:
            image = cvt_color(image, self.current, self.to)
        if self.to == "GRAY" and self.keep_3ch:
            image = np.stack([image] * 3, axis=-1)
        return _ret(image, labels)


class ConvertDataType:
    """uint8 <-> float32 conversion; rounds before casting down to uint8."""

    def __init__(self, to="uint8"):
        if to not in ("uint8", "float32"):
            raise ValueError("`to` must be 'uint8' or 'float32'.")
        self.to = to

    def __call__(self, image, labels=None):
        if self.to == "uint8":
            image = np.round(image, decimals=0).astype(np.uint8)
        else:
            image = image.astype(np.float32)
        return _ret(image, labels)


class ConvertTo3Channels:
    """1ch/4ch -> 3ch; 3-channel images pass through unchanged."""

    def __call__(self, image, labels=None):
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        elif image.ndim == 3 and image.shape[2] == 1:
            image = np.concatenate([image] * 3, axis=-1)
        elif image.ndim == 3 and image.shape[2] == 4:
            image = image[:, :, :3]
        return _ret(image, labels)


class Hue:
    """Shift the H channel of a float HSV image, wrapping modulo 180."""

    def __init__(self, delta):
        if not -180 <= delta <= 180:
            raise ValueError("`delta` must be within [-180, 180].")
        self.delta = delta

    def __call__(self, image, labels=None):
        image[:, :, 0] = (image[:, :, 0] + self.delta) % 180.0
        return _ret(image, labels)


class RandomHue(_Probabilistic):
    def __init__(self, max_delta=18, prob=0.5):
        if not 0 <= max_delta <= 180:
            raise ValueError("`max_delta` must be within [0, 180].")
        self.max_delta = max_delta
        self.prob = prob
        self._op = Hue(delta=0)

    def _draw(self):
        self._op.delta = np.random.uniform(-self.max_delta, self.max_delta)

    def _apply(self, image):
        return self._op(image)


class Saturation:
    """Scale the S channel of a float HSV image, clipped to [0, 255]."""

    def __init__(self, factor):
        if factor <= 0.0:
            raise ValueError("`factor` must be > 0.")
        self.factor = factor

    def __call__(self, image, labels=None):
        image[:, :, 1] = np.clip(image[:, :, 1] * self.factor, 0, 255)
        return _ret(image, labels)


class RandomSaturation(_Probabilistic):
    def __init__(self, lower=0.3, upper=2.0, prob=0.5):
        if lower >= upper:
            raise ValueError("`upper` must be greater than `lower`.")
        self.lower, self.upper, self.prob = lower, upper, prob
        self._op = Saturation(factor=1.0)

    def _draw(self):
        self._op.factor = np.random.uniform(self.lower, self.upper)

    def _apply(self, image):
        return self._op(image)


class Brightness:
    """Add a constant to a float RGB image, clipped to [0, 255]."""

    def __init__(self, delta):
        self.delta = delta

    def __call__(self, image, labels=None):
        return _ret(np.clip(image + self.delta, 0, 255), labels)


class RandomBrightness(_Probabilistic):
    def __init__(self, lower=-84, upper=84, prob=0.5):
        if lower >= upper:
            raise ValueError("`upper` must be greater than `lower`.")
        self.lower, self.upper, self.prob = float(lower), float(upper), prob
        self._op = Brightness(delta=0)

    def _draw(self):
        self._op.delta = np.random.uniform(self.lower, self.upper)

    def _apply(self, image):
        return self._op(image)


class Contrast:
    """Scale a float RGB image around the 127.5 pivot, clipped to [0, 255]."""

    def __init__(self, factor):
        if factor <= 0.0:
            raise ValueError("`factor` must be > 0.")
        self.factor = factor

    def __call__(self, image, labels=None):
        return _ret(np.clip(127.5 + self.factor * (image - 127.5), 0, 255), labels)


class RandomContrast(_Probabilistic):
    def __init__(self, lower=0.5, upper=1.5, prob=0.5):
        if lower >= upper:
            raise ValueError("`upper` must be greater than `lower`.")
        self.lower, self.upper, self.prob = lower, upper, prob
        self._op = Contrast(factor=1.0)

    def _draw(self):
        self._op.factor = np.random.uniform(self.lower, self.upper)

    def _apply(self, image):
        return self._op(image)


class Gamma:
    """Gamma-correct a uint8 RGB image via a 256-entry LUT."""

    def __init__(self, gamma):
        if gamma <= 0.0:
            raise ValueError("`gamma` must be > 0.")
        self.gamma = gamma
        inv = 1.0 / gamma
        self.table = np.array(
            [((i / 255.0) ** inv) * 255 for i in range(256)]
        ).astype("uint8")

    def __call__(self, image, labels=None):
        return _ret(self.table[image], labels)


class RandomGamma(_Probabilistic):
    def __init__(self, lower=0.25, upper=2.0, prob=0.5):
        if lower >= upper:
            raise ValueError("`upper` must be greater than `lower`.")
        self.lower, self.upper, self.prob = lower, upper, prob

    def _draw(self):
        self._op = Gamma(gamma=np.random.uniform(self.lower, self.upper))

    def _apply(self, image):
        return self._op(image)


class HistogramEqualization:
    """Equalize the V channel of a uint8 HSV image."""

    def __call__(self, image, labels=None):
        image[:, :, 2] = equalize_hist(image[:, :, 2])
        return _ret(image, labels)


class RandomHistogramEqualization(_Probabilistic):
    def __init__(self, prob=0.5):
        self.prob = prob
        self._op = HistogramEqualization()

    def _apply(self, image):
        return self._op(image)


class ChannelSwap:
    """Reorder image channels."""

    def __init__(self, order):
        self.order = order

    def __call__(self, image, labels=None):
        return _ret(image[:, :, self.order], labels)


class RandomChannelSwap(_Probabilistic):
    _PERMS = ((0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))

    def __init__(self, prob=0.5):
        self.prob = prob
        self._op = ChannelSwap(order=(0, 1, 2))

    def _draw(self):
        self._op.order = self._PERMS[np.random.randint(5)]

    def _apply(self, image):
        return self._op(image)
