"""SSD training augmentation over a whole batch on the device (PyTorch).

Port of ``ssd_keras_tpu/data/device_aug.py``: the same distribution of
augmentations as the reference's host chain (photometric distortions with
the Caffe-SSD parameters and their two orders, SSD expand onto a mean-colour
canvas, the SSD random crop with 32 candidates of which the first valid one
wins, horizontal flip, resize to the model's input), as batched tensor ops.
Expand, crop and resize compose into one resample of a view rectangle per
image, ``jax.image.scale_and_translate`` with ``antialias=False``: a dense
triangle-weight matrix per axis and per image, contracted with two batched
matmuls, plus a coverage channel that blends the background colour in.

Each stage is split in two:

* a *draw* (:func:`draw_photometric`, :func:`draw_geometry`) makes every
  random parameter of a batch from one ``torch.Generator``;
* a pure *apply* (:func:`photometric_distortions`,
  :func:`geometry_from_draws`, :func:`apply_geometry`) computes the result
  from those parameters.

The draws are made for the *global* batch from a seed every rank shares,
and each rank keeps its own rows (``DeviceSSDAugmentation(mesh=...)``), so
a rank's rows equal the single-process batch's rows bit for bit, as the JAX
package's split of one key over the global batch makes them. The apply
functions follow the JAX package's f32 operations in order, so given the
JAX package's own draws they give its results.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ssd_keras_torch.utils.profiling import spanned

__all__ = [
    "rgb_to_hsv",
    "hsv_to_rgb",
    "PhotometricDraws",
    "GeometryDraws",
    "AugDraws",
    "draw_photometric",
    "draw_geometry",
    "photometric_distortions",
    "geometry_from_draws",
    "resample_weights",
    "apply_geometry",
    "batch_seed",
    "DeviceSSDAugmentation",
]

# The SSD crop's minimum-IoU bounds; a candidate draws one of them.
IOU_BOUNDS = (0.0, 0.1, 0.3, 0.5, 0.7, 0.9)


# --------------------------------------------------------------------------- #
# Colour space (cv2 uint8 ranges: H in [0, 180), S and V in [0, 255])
# --------------------------------------------------------------------------- #


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0, 255] -> HSV with H in [0, 180), S and V in [0, 255]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c == 0, 1.0, c)
    h = torch.where(
        v == r, (g - b) / safe_c,
        torch.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c),
    )
    h = torch.where(c == 0, 0.0, h) * 30.0  # sextant * 60 degrees, halved
    h = torch.where(h < 0, h + 180.0, h)
    s = torch.where(v == 0, 0.0, c / torch.where(v == 0, 1.0, v)) * 255.0
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_to_hsv` (the same cv2 ranges)."""
    h = hsv[..., 0] / 30.0  # [0, 6)
    s = hsv[..., 1] / 255.0
    v = hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # Floor modulo, as jnp's % is: a hue of exactly 180 wraps to sextant 0.
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*values):
        out = values[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, values[k], out)
        return out

    return torch.stack(
        [select(v, q, p, p, t, v), select(t, v, v, q, p, p), select(p, p, t, v, v, q)], dim=-1
    )


# --------------------------------------------------------------------------- #
# Draws
# --------------------------------------------------------------------------- #


class PhotometricDraws(NamedTuple):
    """Per-sample photometric parameters, each of shape (B,)."""

    brightness_gate: torch.Tensor  # bool
    brightness_delta: torch.Tensor
    contrast_first: torch.Tensor  # bool: contrast before the HSV round trip
    contrast_gate: torch.Tensor  # bool; one draw serves both orders
    contrast_factor: torch.Tensor
    saturation_gate: torch.Tensor  # bool
    saturation_factor: torch.Tensor
    hue_gate: torch.Tensor  # bool
    hue_delta: torch.Tensor


class GeometryDraws(NamedTuple):
    """Per-sample geometry parameters: (B,) unless noted; K = candidates."""

    expand: torch.Tensor  # bool
    expand_ratio: torch.Tensor  # in [1, max_expand)
    expand_offset: torch.Tensor  # (B, 2) y, x in [0, 1)
    crop_attempt: torch.Tensor  # bool
    bound_index: torch.Tensor  # (B, K) int64 into IOU_BOUNDS
    crop_scale: torch.Tensor  # (B, K, 2) h, w in [0.3, 1)
    crop_position: torch.Tensor  # (B, K, 2) y, x in [0, 1)
    flip: torch.Tensor  # bool


class AugDraws(NamedTuple):
    """Everything :class:`DeviceSSDAugmentation` draws for one batch."""

    photometric: PhotometricDraws
    geometry: GeometryDraws

    def rows(self, index) -> "AugDraws":
        """The draws of the rows ``index`` (a slice or an index tensor)."""
        return AugDraws(*(type(g)(*(t[index] for t in g)) for g in self))

    def to(self, device) -> "AugDraws":
        return AugDraws(*(type(g)(*(t.to(device) for t in g)) for g in self))


def _uniform(u: torch.Tensor, low: float, high: float) -> torch.Tensor:
    return low + (high - low) * u


def draw_photometric(
    generator: torch.Generator,
    batch: int,
    brightness_delta: float = 32.0,
    contrast_range: Tuple[float, float] = (0.5, 1.5),
    saturation_range: Tuple[float, float] = (0.5, 1.5),
    hue_delta: float = 18.0,
) -> PhotometricDraws:
    """The photometric parameters of ``batch`` samples, on the generator's
    device: every distortion fires with probability 0.5, contrast runs
    before or after the HSV round trip with probability 0.5 each."""
    u = torch.rand(batch, 9, generator=generator, device=generator.device)
    return PhotometricDraws(
        brightness_gate=u[:, 0] >= 0.5,
        brightness_delta=_uniform(u[:, 1], -brightness_delta, brightness_delta),
        contrast_first=u[:, 2] >= 0.5,
        contrast_gate=u[:, 3] >= 0.5,
        contrast_factor=_uniform(u[:, 4], *contrast_range),
        saturation_gate=u[:, 5] >= 0.5,
        saturation_factor=_uniform(u[:, 6], *saturation_range),
        hue_gate=u[:, 7] >= 0.5,
        hue_delta=_uniform(u[:, 8], -hue_delta, hue_delta),
    )


def draw_geometry(
    generator: torch.Generator,
    batch: int,
    n_candidates: int = 32,
    expand_prob: float = 0.5,
    crop_attempt_prob: float = 0.857,
    max_expand: float = 4.0,
) -> GeometryDraws:
    """The geometry parameters of ``batch`` samples: maybe expand (ratio
    U[1, max_expand), uniform placement), maybe crop (per candidate a
    minimum-IoU bound, a scale U[0.3, 1) per axis and a position), maybe
    flip. One ``torch.rand`` call on the generator's device."""
    k = n_candidates
    u = torch.rand(batch, 6 + 5 * k, generator=generator, device=generator.device)
    cand = u[:, 6:].reshape(batch, k, 5)
    return GeometryDraws(
        expand=u[:, 0] >= 1.0 - expand_prob,
        expand_ratio=_uniform(u[:, 1], 1.0, max_expand),
        expand_offset=u[:, 2:4],
        crop_attempt=u[:, 4] >= 1.0 - crop_attempt_prob,
        bound_index=(cand[..., 0] * len(IOU_BOUNDS)).to(torch.int64).clamp_max(len(IOU_BOUNDS) - 1),
        crop_scale=_uniform(cand[..., 1:3], 0.3, 1.0),
        crop_position=cand[..., 3:5],
        flip=u[:, 5] >= 0.5,
    )


def batch_seed(seed: int, index: int) -> int:
    """The augmentation seed of batch ``index`` of a run seeded ``seed``: a
    pure function of both, computed on the host, so a resumed or streamed
    run draws what the direct one does and no rank reads the device for it."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


# --------------------------------------------------------------------------- #
# Apply
# --------------------------------------------------------------------------- #


def photometric_distortions(image: torch.Tensor, d: PhotometricDraws) -> torch.Tensor:
    """Caffe-SSD photometric distortions of a (B, H, W, 3) f32 batch in
    [0, 255], given the draws: brightness, then contrast either before or
    after the saturation and hue changes in HSV."""

    def per_sample(t):
        return t[:, None, None]

    def per_pixel(t):
        return t[:, None, None, None]

    def contrast(x):
        return 127.5 + per_pixel(d.contrast_factor) * (x - 127.5)

    def maybe_contrast(x):
        return torch.where(per_pixel(d.contrast_gate), contrast(x), x)

    first = per_pixel(d.contrast_first)
    image = torch.where(per_pixel(d.brightness_gate), image + per_pixel(d.brightness_delta), image)
    image = torch.clamp(image, 0.0, 255.0)
    image = torch.where(first, torch.clamp(maybe_contrast(image), 0, 255), image)

    hsv = rgb_to_hsv(image)
    s = torch.where(per_sample(d.saturation_gate),
                    torch.clamp(hsv[..., 1] * per_sample(d.saturation_factor), 0, 255), hsv[..., 1])
    h = torch.where(per_sample(d.hue_gate),
                    torch.remainder(hsv[..., 0] + per_sample(d.hue_delta), 180.0), hsv[..., 0])
    image = hsv_to_rgb(torch.stack([h, s, hsv[..., 2]], dim=-1))

    image = torch.where(first, image, torch.clamp(maybe_contrast(image), 0, 255))
    return torch.clamp(image, 0.0, 255.0)


def geometry_from_draws(
    d: GeometryDraws,
    boxes: torch.Tensor,  # (B, M, 4) corners in the original image's pixels
    n_valid: torch.Tensor,  # (B,)
    img_height: int,
    img_width: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The view rectangle (B, 4) = (y0, x0, y1, x1) in original pixels, and
    the flip (B,), given the draws.

    Expand grows the view to ``ratio`` times the image with the image at a
    uniform offset inside; the crop takes, of K candidates over the view,
    the first whose aspect ratio lies in [0.5, 2] and whose IoU with some
    live box exceeds its bound; no valid candidate, or no attempt, keeps
    the view.
    """
    dev = boxes.device
    exp_h = img_height * d.expand_ratio
    exp_w = img_width * d.expand_ratio
    exp_y0 = -d.expand_offset[:, 0] * (exp_h - img_height)
    exp_x0 = -d.expand_offset[:, 1] * (exp_w - img_width)
    # Scalars, not a tensor from the host: that copy would wait for the device.
    view = torch.stack([
        torch.where(d.expand, exp_y0, 0.0),
        torch.where(d.expand, exp_x0, 0.0),
        torch.where(d.expand, exp_y0 + exp_h, float(img_height)),
        torch.where(d.expand, exp_x0 + exp_w, float(img_width)),
    ], dim=-1)
    view_h = (view[:, 2] - view[:, 0])[:, None]
    view_w = (view[:, 3] - view[:, 1])[:, None]

    ph = d.crop_scale[..., 0] * view_h  # (B, K)
    pw = d.crop_scale[..., 1] * view_w
    ar_ok = (pw / ph >= 0.5) & (pw / ph <= 2.0)
    py0 = view[:, 0:1] + d.crop_position[..., 0] * (view_h - ph)
    px0 = view[:, 1:2] + d.crop_position[..., 1] * (view_w - pw)
    px1, py1 = px0 + pw, py0 + ph

    # IoU of every candidate patch with every box: (B, K, M).
    bx = boxes[:, None, :, :]
    x1 = torch.maximum(px0[..., None], bx[..., 0])
    y1 = torch.maximum(py0[..., None], bx[..., 1])
    x2 = torch.minimum(px1[..., None], bx[..., 2])
    y2 = torch.minimum(py1[..., None], bx[..., 3])
    inter = torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)
    area_p = ((px1 - px0) * (py1 - py0))[..., None]
    area_b = (bx[..., 2] - bx[..., 0]) * (bx[..., 3] - bx[..., 1])
    union = area_p + area_b - inter
    ious = torch.where(union > 0, inter / union, 0.0)
    bounds = torch.zeros_like(ious[..., 0])  # (B, K): each candidate's bound
    for i, bound in enumerate(IOU_BOUNDS):
        bounds = torch.where(d.bound_index == i, bound, bounds)
    live = torch.arange(boxes.shape[1], device=dev)[None, :] < n_valid[:, None]  # (B, M)
    any_ok = (live[:, None, :] & (ious > bounds[..., None])).any(dim=-1)
    valid = ar_ok & any_ok  # (B, K)

    first = valid.to(torch.int32).argmax(dim=1)  # first valid candidate (0 if none)
    rects = torch.stack([py0, px0, py1, px1], dim=-1)  # (B, K, 4)
    crop_rect = rects.gather(1, first[:, None, None].expand(-1, 1, 4))[:, 0]
    rect = torch.where((d.crop_attempt & valid.any(dim=1))[:, None], crop_rect, view)
    return rect, d.flip


def resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """(B, out, in) linear-interpolation weights of
    ``jax.image.scale_and_translate`` with ``antialias=False`` for per-sample
    (B,) ``scale`` and ``translation`` along one axis: triangle weights at
    ``sample = (o + 0.5 - t) / s - 0.5``, normalised by their sum (0 where
    the sum is at most 1000 eps), and 0 where the sample lies outside
    [-0.5, in - 0.5]."""
    dev, dt = scale.device, scale.dtype
    inv_scale = (1.0 / scale)[:, None]
    sample = ((torch.arange(out_size, dtype=dt, device=dev) + 0.5)[None, :] * inv_scale
              - translation[:, None] * inv_scale - 0.5)  # (B, out)
    x = torch.abs(sample[:, :, None] - torch.arange(in_size, dtype=dt, device=dev))
    weights = torch.clamp_min(1.0 - x, 0.0)  # (B, out, in)
    total = weights.sum(dim=2, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, 1.0),
        0.0,
    )
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], weights, 0.0)


def apply_geometry(
    image: torch.Tensor,  # (B, H, W, 3) f32 RGB, the original images
    boxes: torch.Tensor,  # (B, M, 4) corners in original pixels
    n_valid: torch.Tensor,  # (B,)
    rect: torch.Tensor,  # (B, 4) y0, x0, y1, x1 in original pixels
    flip: torch.Tensor,  # (B,) bool
    out_height: int,
    out_width: int,
    background: torch.Tensor,  # (3,) the mean colour
):
    """Resample each view rectangle to (out_height, out_width) and map the
    boxes. Returns ``(images (B, oh, ow, 3), boxes (B, M, 4), keep (B, M))``.

    The image carries a fourth channel of ones through the same resample:
    its result is the coverage of the output pixel by the image, and
    ``1 - coverage`` of the background colour fills the rest, as a canvas
    padded with the mean colour would. The flip reverses the width weights'
    output rows. Boxes keep the reference's center-point criterion, then are
    clipped; a box that is degenerate after clipping is dropped.
    """
    b, in_h, in_w, _ = image.shape
    y0, x0, y1, x1 = rect.unbind(-1)
    sy = out_height / (y1 - y0)
    sx = out_width / (x1 - x0)
    wy = resample_weights(in_h, out_height, sy, -y0 * sy)  # (B, oh, H)
    wx = resample_weights(in_w, out_width, sx, -x0 * sx)  # (B, ow, W)
    wx = torch.where(flip[:, None, None], wx.flip(1), wx)

    rgba = torch.cat([image, torch.ones_like(image[..., :1])], dim=-1)  # (B, H, W, 4)
    rows = torch.bmm(wy, rgba.reshape(b, in_h, in_w * 4))  # (B, oh, W*4)
    cols = rows.reshape(b, out_height, in_w, 4).transpose(1, 2).reshape(b, in_w, out_height * 4)
    out = torch.bmm(wx, cols).reshape(b, out_width, out_height, 4).transpose(1, 2)
    coverage = torch.clamp(out[..., 3:4], 0.0, 1.0)
    out_rgb = out[..., :3] + (1.0 - coverage) * background
    out_rgb = torch.clamp(out_rgb, 0.0, 255.0).contiguous()

    y0, x0, sy, sx, fl = y0[:, None], x0[:, None], sy[:, None], sx[:, None], flip[:, None]
    bx0 = (boxes[..., 0] - x0) * sx
    by0 = (boxes[..., 1] - y0) * sy
    bx1 = (boxes[..., 2] - x0) * sx
    by1 = (boxes[..., 3] - y0) * sy
    fx0 = torch.where(fl, out_width - bx1, bx0)
    fx1 = torch.where(fl, out_width - bx0, bx1)
    cx = (fx0 + fx1) / 2.0
    cy = (by0 + by1) / 2.0
    live = torch.arange(boxes.shape[1], device=boxes.device)[None, :] < n_valid[:, None]
    # The reference's center_point criterion (validation_utils.py:225-230).
    keep = live & (cx >= 0) & (cx <= out_width - 1) & (cy >= 0) & (cy <= out_height - 1)
    fx0 = torch.clamp(fx0, 0, out_width - 1)
    fx1 = torch.clamp(fx1, 0, out_width - 1)
    by0c = torch.clamp(by0, 0, out_height - 1)
    by1c = torch.clamp(by1, 0, out_height - 1)
    keep = keep & (fx1 > fx0) & (by1c > by0c)
    return out_rgb, torch.stack([fx0, by0c, fx1, by1c], dim=-1), keep


class DeviceSSDAugmentation:
    """The batched on-device counterpart of ``SSDDataAugmentation``.

    ``aug(seed, images, labels, n_valid)`` takes a uint8 or float batch of
    equally sized (B, H, W, 3) images with padded (B, M, 5) labels and (B,)
    counts, all on one device, and returns the augmented (B, oh, ow, 3) f32
    images, the (B, M, 5) labels with the kept boxes compacted to the front
    and zeros after them, and the (B,) int32 counts: what
    ``SSDInputEncoder.encode_padded`` takes.

    ``seed`` seeds a generator on the images' device, kept by this object,
    from which :meth:`draw` makes the batch's parameters. With ``mesh`` (a
    1-D data mesh, ``parallel.sharding.make_mesh``), the batch given is the
    rank's rows of the global batch: the draws are made for the global batch
    (rank-local rows times the mesh size) and the rank keeps its own, so
    every rank must pass the same seed.
    """

    def __init__(
        self,
        img_height: int = 300,
        img_width: int = 300,
        background: Sequence[float] = (123.0, 117.0, 104.0),
        mesh=None,
    ):
        self.out_h = int(img_height)
        self.out_w = int(img_width)
        self.background = tuple(float(v) for v in background)
        self.mesh = mesh
        self._generators = {}
        self._backgrounds = {}

    def _generator(self, device: torch.device) -> torch.Generator:
        gen = self._generators.get(device)
        if gen is None:
            gen = self._generators[device] = torch.Generator(device=device)
        return gen

    @spanned("aug.draw")
    def draw(self, seed: int, batch: int, device) -> AugDraws:
        """The draws of a ``batch``-sample batch seeded ``seed``."""
        gen = self._generator(torch.device(device))
        gen.manual_seed(int(seed))
        return AugDraws(draw_photometric(gen, batch), draw_geometry(gen, batch))

    @spanned("aug.apply")
    def apply(self, draws: AugDraws, images, labels, n_valid):
        """The augmentation of the batch given its draws (rows aligned)."""
        image = images.to(torch.float32)
        labels = labels.to(torch.float32)
        n_valid = n_valid.to(torch.int64)
        image = photometric_distortions(image, draws.photometric)
        boxes = labels[..., 1:5]
        rect, flip = geometry_from_draws(draws.geometry, boxes, n_valid,
                                         image.shape[1], image.shape[2])
        bg = self._backgrounds.get(image.device)
        if bg is None:
            bg = self._backgrounds[image.device] = torch.tensor(self.background, device=image.device)
        out, new_boxes, keep = apply_geometry(image, boxes, n_valid, rect, flip,
                                              self.out_h, self.out_w, bg)
        # Kept boxes first, in their order (a stable sort of "dropped").
        order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
        new_labels = torch.cat([labels[..., :1], new_boxes], dim=-1)
        new_labels = new_labels.gather(1, order[..., None].expand(-1, -1, 5))
        count = keep.sum(dim=1)
        dropped = torch.arange(keep.shape[1], device=keep.device)[None, :] >= count[:, None]
        new_labels = torch.where(dropped[..., None], 0.0, new_labels)
        return out, new_labels, count.to(torch.int32)

    @spanned("aug")
    def __call__(self, seed: int, images, labels, n_valid):
        batch = images.shape[0]
        if self.mesh is None:
            draws = self.draw(seed, batch, images.device)
        else:
            rank = self.mesh.get_local_rank()
            draws = self.draw(seed, batch * self.mesh.size(), images.device)
            draws = draws.rows(slice(rank * batch, (rank + 1) * batch))
        return self.apply(draws, images, labels, n_valid)
