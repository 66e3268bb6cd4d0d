"""Random patch sampling (crop/pad/expand) for 2D detection augmentation.

Capability parity with
data_generator/object_detection_2d_patch_sampling_ops.py:
``PatchCoordinateGenerator`` :24, ``CropPad`` :199, ``Crop`` :350, ``Pad``
:390, ``RandomPatch`` :429, ``RandomPatchInf`` :591, ``RandomMaxCropFixedAR``
:744, ``RandomPadFixedAR`` :823.

The sampled patch may extend beyond the image on any side (negative
``ymin``/``xmin`` or size larger than the image); the out-of-image region is
filled with a constant background color — that single canvas primitive covers
crops, pads, and the SSD "expand" augmentation.

Vendored from ``ssd_keras_tpu/data/patch_sampling.py`` (NumPy only) with only the import
paths changed, so that the PyTorch port imports without JAX.
"""

from __future__ import annotations

import numpy as np

from ssd_keras_torch.data.validation import DEFAULT_LABELS_FORMAT

__all__ = [
    "PatchCoordinateGenerator",
    "CropPad",
    "Crop",
    "Pad",
    "RandomPatch",
    "RandomPatchInf",
    "RandomMaxCropFixedAR",
    "RandomPadFixedAR",
]


class PatchCoordinateGenerator:
    """Draws random patch geometry ``(ymin, xmin, height, width)``.

    ``must_match`` selects which two of {height, width, aspect ratio} are the
    independent variables ('h_w', 'h_ar', 'w_ar'). Scales are fractions of the
    image dimensions and may exceed 1 (patch larger than the image). When a
    patch doesn't fit, its corner is drawn from the negative range so that the
    patch always maximally overlaps the image.
    """

    def __init__(
        self,
        img_height=None,
        img_width=None,
        must_match="h_w",
        min_scale=0.3,
        max_scale=1.0,
        scale_uniformly=False,
        min_aspect_ratio=0.5,
        max_aspect_ratio=2.0,
        patch_ymin=None,
        patch_xmin=None,
        patch_height=None,
        patch_width=None,
        patch_aspect_ratio=None,
    ):
        if must_match not in ("h_w", "h_ar", "w_ar"):
            raise ValueError("`must_match` must be 'h_w', 'h_ar' or 'w_ar'.")
        if min_scale >= max_scale:
            raise ValueError("It must be min_scale < max_scale.")
        if min_aspect_ratio >= max_aspect_ratio:
            raise ValueError("It must be min_aspect_ratio < max_aspect_ratio.")
        if scale_uniformly and not (patch_height is None and patch_width is None):
            raise ValueError(
                "With scale_uniformly=True, patch_height and patch_width must be None."
            )
        self.img_height = img_height
        self.img_width = img_width
        self.must_match = must_match
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.scale_uniformly = scale_uniformly
        self.min_aspect_ratio = min_aspect_ratio
        self.max_aspect_ratio = max_aspect_ratio
        self.patch_ymin = patch_ymin
        self.patch_xmin = patch_xmin
        self.patch_height = patch_height
        self.patch_width = patch_width
        self.patch_aspect_ratio = patch_aspect_ratio

    def _scale(self):
        return np.random.uniform(self.min_scale, self.max_scale)

    def _ar(self):
        if self.patch_aspect_ratio is not None:
            return self.patch_aspect_ratio
        return np.random.uniform(self.min_aspect_ratio, self.max_aspect_ratio)

    def __call__(self):
        if self.must_match == "h_w":
            if self.scale_uniformly:
                s = self._scale()
                h = int(s * self.img_height)
                w = int(s * self.img_width)
            else:
                h = self.patch_height if self.patch_height is not None else int(
                    self._scale() * self.img_height
                )
                w = self.patch_width if self.patch_width is not None else int(
                    self._scale() * self.img_width
                )
        elif self.must_match == "h_ar":
            h = self.patch_height if self.patch_height is not None else int(
                self._scale() * self.img_height
            )
            w = int(h * self._ar())
        else:  # 'w_ar'
            w = self.patch_width if self.patch_width is not None else int(
                self._scale() * self.img_width
            )
            h = int(w / self._ar())

        def corner(fixed, room):
            if fixed is not None:
                return fixed
            # room >= 0: patch fits — any of the room+1 positions inside.
            # room < 0: patch is larger — place so it fully covers the image.
            return np.random.randint(0, room + 1) if room >= 0 else np.random.randint(room, 1)

        ymin = corner(self.patch_ymin, self.img_height - h)
        xmin = corner(self.patch_xmin, self.img_width - w)
        return (ymin, xmin, h, w)


class CropPad:
    """Deterministic crop-and/or-pad onto a constant-color canvas.

    The patch is given in the input image's coordinate frame and may lie
    partially outside it; the overlap is copied onto the canvas, the rest is
    background. Boxes are translated into the patch frame, optionally filtered
    and clipped.
    """

    def __init__(
        self,
        patch_ymin,
        patch_xmin,
        patch_height,
        patch_width,
        clip_boxes=True,
        box_filter=None,
        background=(0, 0, 0),
        labels_format=None,
    ):
        self.patch_ymin = patch_ymin
        self.patch_xmin = patch_xmin
        self.patch_height = patch_height
        self.patch_width = patch_width
        self.clip_boxes = clip_boxes
        self.box_filter = box_filter
        self.background = background
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)

    def __call__(self, image, labels=None, return_inverter=False):
        img_height, img_width = image.shape[:2]
        py, px = self.patch_ymin, self.patch_xmin
        ph, pw = self.patch_height, self.patch_width
        if py > img_height or px > img_width:
            raise ValueError("The given patch doesn't overlap with the input image.")

        if image.ndim == 3:
            canvas = np.empty((ph, pw, 3), dtype=np.uint8)
            canvas[:, :] = self.background
        else:
            canvas = np.full((ph, pw), self.background[0], dtype=np.uint8)

        # Overlap of the patch window with the image, in image coordinates...
        iy0, iy1 = max(py, 0), min(py + ph, img_height)
        ix0, ix1 = max(px, 0), min(px + pw, img_width)
        if iy1 > iy0 and ix1 > ix0:
            # ...copied to the corresponding canvas coordinates.
            canvas[iy0 - py : iy1 - py, ix0 - px : ix1 - px] = image[iy0:iy1, ix0:ix1]
        image = canvas

        fx = self.labels_format
        xmin, ymin, xmax, ymax = fx["xmin"], fx["ymin"], fx["xmax"], fx["ymax"]

        if return_inverter:
            def inverter(preds):
                preds = np.copy(preds)
                preds[:, [ymin + 1, ymax + 1]] += py
                preds[:, [xmin + 1, xmax + 1]] += px
                return preds

        if labels is None:
            return (image, inverter) if return_inverter else image

        labels = np.copy(labels)
        labels[:, [ymin, ymax]] -= py
        labels[:, [xmin, xmax]] -= px
        if self.box_filter is not None:
            self.box_filter.labels_format = self.labels_format
            labels = self.box_filter(labels, image_height=ph, image_width=pw)
        if self.clip_boxes:
            labels[:, [ymin, ymax]] = np.clip(labels[:, [ymin, ymax]], 0, ph - 1)
            labels[:, [xmin, xmax]] = np.clip(labels[:, [xmin, xmax]], 0, pw - 1)
        return (image, labels, inverter) if return_inverter else (image, labels)


class Crop:
    """Crop fixed pixel counts off each border (CropPad convenience)."""

    def __init__(self, crop_top, crop_bottom, crop_left, crop_right,
                 clip_boxes=True, box_filter=None, labels_format=None):
        self.crop_top, self.crop_bottom = crop_top, crop_bottom
        self.crop_left, self.crop_right = crop_left, crop_right
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.crop = CropPad(
            patch_ymin=crop_top, patch_xmin=crop_left,
            patch_height=None, patch_width=None,
            clip_boxes=clip_boxes, box_filter=box_filter,
            labels_format=self.labels_format,
        )

    def __call__(self, image, labels=None, return_inverter=False):
        img_height, img_width = image.shape[:2]
        self.crop.patch_height = img_height - self.crop_top - self.crop_bottom
        self.crop.patch_width = img_width - self.crop_left - self.crop_right
        self.crop.labels_format = self.labels_format
        return self.crop(image, labels, return_inverter)


class Pad:
    """Pad fixed pixel counts onto each border (CropPad convenience)."""

    def __init__(self, pad_top, pad_bottom, pad_left, pad_right,
                 background=(0, 0, 0), labels_format=None):
        self.pad_top, self.pad_bottom = pad_top, pad_bottom
        self.pad_left, self.pad_right = pad_left, pad_right
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.pad = CropPad(
            patch_ymin=-pad_top, patch_xmin=-pad_left,
            patch_height=None, patch_width=None,
            clip_boxes=False, box_filter=None, background=background,
            labels_format=self.labels_format,
        )

    def __call__(self, image, labels=None, return_inverter=False):
        img_height, img_width = image.shape[:2]
        self.pad.patch_height = img_height + self.pad_top + self.pad_bottom
        self.pad.patch_width = img_width + self.pad_left + self.pad_right
        self.pad.labels_format = self.labels_format
        return self.pad(image, labels, return_inverter)


def _identity_inverter(preds):
    return preds


class RandomPatch:
    """Sample a random patch; may fail (returning None) if ``can_fail``.

    Each of ``n_trials_max`` trials draws patch geometry and accepts it if the
    translated boxes pass ``image_validator``; on failure returns ``None``
    (``can_fail=True``) or the unaltered input.
    """

    def __init__(
        self,
        patch_coord_generator,
        box_filter=None,
        image_validator=None,
        n_trials_max=3,
        clip_boxes=True,
        prob=1.0,
        background=(0, 0, 0),
        can_fail=False,
        labels_format=None,
    ):
        self.patch_coord_generator = patch_coord_generator
        self.image_validator = image_validator
        self.n_trials_max = n_trials_max
        self.prob = prob
        self.can_fail = can_fail
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.sample_patch = CropPad(
            patch_ymin=None, patch_xmin=None, patch_height=None, patch_width=None,
            clip_boxes=clip_boxes, box_filter=box_filter, background=background,
            labels_format=self.labels_format,
        )

    def _try_once(self, image, labels, return_inverter):
        """One geometry draw; returns the transform output or None if invalid."""
        gen = self.patch_coord_generator
        py, px, ph, pw = gen()
        sp = self.sample_patch
        sp.patch_ymin, sp.patch_xmin, sp.patch_height, sp.patch_width = py, px, ph, pw
        if labels is None or self.image_validator is None:
            return sp(image, labels, return_inverter)
        fx = self.labels_format
        candidate = np.copy(labels)
        candidate[:, [fx["ymin"], fx["ymax"]]] -= py
        candidate[:, [fx["xmin"], fx["xmax"]]] -= px
        if self.image_validator(candidate, image_height=ph, image_width=pw):
            return sp(image, labels, return_inverter)
        return None

    def __call__(self, image, labels=None, return_inverter=False):
        if np.random.uniform(0, 1) >= (1.0 - self.prob):
            gen = self.patch_coord_generator
            gen.img_height, gen.img_width = image.shape[:2]
            if self.image_validator is not None:
                self.image_validator.labels_format = self.labels_format
            self.sample_patch.labels_format = self.labels_format

            for _ in range(max(1, self.n_trials_max)):
                out = self._try_once(image, labels, return_inverter)
                if out is not None:
                    return out

            if self.can_fail:  # propagate failure as None placeholders
                n_out = 1 + (labels is not None) + return_inverter
                return None if n_out == 1 else (None,) * n_out
            # fall back to the unaltered input (inverter slot is None)
            outs = (image,) + ((labels,) if labels is not None else ())
            if return_inverter:
                outs = outs + (None,)
            return outs[0] if len(outs) == 1 else outs

        outs = (image,) + ((labels,) if labels is not None else ())
        if return_inverter:
            outs = outs + (_identity_inverter,)
        return outs[0] if len(outs) == 1 else outs


class RandomPatchInf:
    """Sample patches until one is valid or the input is returned unaltered.

    The reference's unbounded retry loop (patch_sampling_ops.py:689-727):
    every round, with probability ``1 - prob`` the original image is returned;
    otherwise fresh validator bounds are drawn from ``bound_generator`` and up
    to ``n_trials_max`` patch geometries are tried (patches failing the
    generator's aspect-ratio range are skipped). Cannot dead-end.
    """

    def __init__(
        self,
        patch_coord_generator,
        box_filter=None,
        image_validator=None,
        bound_generator=None,
        n_trials_max=50,
        clip_boxes=True,
        prob=0.857,
        background=(0, 0, 0),
        labels_format=None,
    ):
        self.patch_coord_generator = patch_coord_generator
        self.image_validator = image_validator
        self.bound_generator = bound_generator
        self.n_trials_max = n_trials_max
        self.prob = prob
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.sample_patch = CropPad(
            patch_ymin=None, patch_xmin=None, patch_height=None, patch_width=None,
            clip_boxes=clip_boxes, box_filter=box_filter, background=background,
            labels_format=self.labels_format,
        )

    def __call__(self, image, labels=None, return_inverter=False):
        gen = self.patch_coord_generator
        gen.img_height, gen.img_width = image.shape[:2]
        fx = self.labels_format
        if self.image_validator is not None:
            self.image_validator.labels_format = self.labels_format
        self.sample_patch.labels_format = self.labels_format

        while True:
            if np.random.uniform(0, 1) < (1.0 - self.prob):
                outs = (image,) + ((labels,) if labels is not None else ())
                if return_inverter:
                    outs = outs + (_identity_inverter,)
                return outs[0] if len(outs) == 1 else outs

            if self.image_validator is not None and self.bound_generator is not None:
                self.image_validator.bounds = self.bound_generator()

            for _ in range(max(1, self.n_trials_max)):
                py, px, ph, pw = gen()
                if not (gen.min_aspect_ratio <= pw / ph <= gen.max_aspect_ratio):
                    continue
                sp = self.sample_patch
                sp.patch_ymin, sp.patch_xmin = py, px
                sp.patch_height, sp.patch_width = ph, pw
                if labels is None or self.image_validator is None:
                    return sp(image, labels, return_inverter)
                candidate = np.copy(labels)
                candidate[:, [fx["ymin"], fx["ymax"]]] -= py
                candidate[:, [fx["xmin"], fx["xmax"]]] -= px
                if self.image_validator(candidate, image_height=ph, image_width=pw):
                    return sp(image, labels, return_inverter)


class RandomMaxCropFixedAR:
    """Crop the largest possible patch with a fixed aspect ratio."""

    def __init__(self, patch_aspect_ratio, box_filter=None, image_validator=None,
                 n_trials_max=3, clip_boxes=True, labels_format=None):
        self.patch_aspect_ratio = patch_aspect_ratio
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.random_patch = RandomPatch(
            patch_coord_generator=PatchCoordinateGenerator(),
            box_filter=box_filter, image_validator=image_validator,
            n_trials_max=n_trials_max, clip_boxes=clip_boxes, prob=1.0,
            can_fail=False, labels_format=self.labels_format,
        )

    def __call__(self, image, labels=None, return_inverter=False):
        img_height, img_width = image.shape[:2]
        if img_width / img_height < self.patch_aspect_ratio:
            pw = img_width
            ph = int(round(pw / self.patch_aspect_ratio))
        else:
            ph = img_height
            pw = int(round(ph * self.patch_aspect_ratio))
        self.random_patch.patch_coord_generator = PatchCoordinateGenerator(
            img_height=img_height, img_width=img_width, must_match="h_w",
            patch_height=ph, patch_width=pw,
        )
        self.random_patch.labels_format = self.labels_format
        return self.random_patch(image, labels, return_inverter)


class RandomPadFixedAR:
    """Minimal padding to reach a fixed aspect ratio containing the image."""

    def __init__(self, patch_aspect_ratio, background=(0, 0, 0), labels_format=None):
        self.patch_aspect_ratio = patch_aspect_ratio
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.random_patch = RandomPatch(
            patch_coord_generator=PatchCoordinateGenerator(),
            box_filter=None, image_validator=None, n_trials_max=1,
            clip_boxes=False, background=background, prob=1.0,
            labels_format=self.labels_format,
        )

    def __call__(self, image, labels=None, return_inverter=False):
        img_height, img_width = image.shape[:2]
        if img_width < img_height:
            ph = img_height
            pw = int(round(ph * self.patch_aspect_ratio))
        else:
            pw = img_width
            ph = int(round(pw / self.patch_aspect_ratio))
        self.random_patch.patch_coord_generator = PatchCoordinateGenerator(
            img_height=img_height, img_width=img_width, must_match="h_w",
            patch_height=ph, patch_width=pw,
        )
        self.random_patch.labels_format = self.labels_format
        return self.random_patch(image, labels, return_inverter)
