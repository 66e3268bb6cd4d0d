"""Prebuilt augmentation chains, host-side, without OpenCV.

Port of ``ssd_keras_tpu/data/chains.py``, which has capability parity with
the reference's four chain modules:

* :class:`SSDDataAugmentation`: the Caffe-faithful original-SSD train chain
  (photometric distortions, expand, random crop, flip, random-interpolation
  resize),
* :class:`DataAugmentationConstantInputSize` (what SSD7 training uses),
* :class:`DataAugmentationVariableInputSize`,
* :class:`DataAugmentationSatellite`.

Each chain is built from the port's ``patch_sampling`` and ``validation``
(vendored) and its ``photometric`` and ``geometric`` transforms (whose
resize, warp and colour conversions run in the host C++ of
``native.image_ops``), and
draws from the global ``np.random`` and ``random`` in the JAX package's
order, so one seed gives the JAX package's boxes bit for bit. Pixels follow
the transforms' own agreement with OpenCV (see ``photometric`` and
``geometric``).
"""

from __future__ import annotations

import inspect

import numpy as np

from ssd_keras_torch.data.geometric import (
    RandomFlip,
    RandomRotate,
    RandomScale,
    RandomTranslate,
    Resize,
    ResizeRandomInterp,
)
from ssd_keras_torch.data.patch_sampling import (
    PatchCoordinateGenerator,
    RandomPatch,
    RandomPatchInf,
)
from ssd_keras_torch.data.photometric import (
    ConvertColor,
    ConvertDataType,
    ConvertTo3Channels,
    RandomBrightness,
    RandomChannelSwap,
    RandomContrast,
    RandomHue,
    RandomSaturation,
)
from ssd_keras_torch.data.validation import (
    DEFAULT_LABELS_FORMAT,
    BoundGenerator,
    BoxFilter,
    ImageValidator,
)

__all__ = [
    "SSDRandomCrop",
    "SSDExpand",
    "SSDPhotometricDistortions",
    "SSDDataAugmentation",
    "DataAugmentationConstantInputSize",
    "DataAugmentationVariableInputSize",
    "DataAugmentationSatellite",
]


class _Chain:
    """Applies a transform sequence, collecting inverters when asked."""

    sequence = ()

    def _propagate_format(self):
        for t in self.sequence:
            if hasattr(t, "labels_format"):
                t.labels_format = self.labels_format

    def __call__(self, image, labels, return_inverter=False):
        self._propagate_format()
        inverters = []
        for transform in self.sequence:
            if return_inverter and (
                "return_inverter" in inspect.signature(transform.__call__).parameters
            ):
                image, labels, inverter = transform(image, labels, return_inverter=True)
                inverters.append(inverter)
            else:
                image, labels = transform(image, labels)
        if return_inverter:
            return image, labels, inverters[::-1]
        return image, labels


class SSDRandomCrop:
    """The original SSD `batch_sampler` random crop: a fresh min-IoU bound in
    {none, .1, .3, .5, .7, .9} each round, patches with scale in [0.3, 1] and
    AR in [0.5, 2], center-point box filtering — run until success."""

    def __init__(self, labels_format=None):
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.bound_generator = BoundGenerator(
            sample_space=((None, None), (0.1, None), (0.3, None),
                          (0.5, None), (0.7, None), (0.9, None)),
            weights=None,
        )
        self.patch_coord_generator = PatchCoordinateGenerator(
            must_match="h_w", min_scale=0.3, max_scale=1.0, scale_uniformly=False,
            min_aspect_ratio=0.5, max_aspect_ratio=2.0,
        )
        self.box_filter = BoxFilter(
            check_overlap=True, check_min_area=False, check_degenerate=False,
            overlap_criterion="center_point", labels_format=self.labels_format,
        )
        self.image_validator = ImageValidator(
            overlap_criterion="iou", n_boxes_min=1,
            labels_format=self.labels_format, border_pixels="half",
        )
        self.random_crop = RandomPatchInf(
            patch_coord_generator=self.patch_coord_generator,
            box_filter=self.box_filter,
            image_validator=self.image_validator,
            bound_generator=self.bound_generator,
            n_trials_max=50, clip_boxes=True, prob=0.857,
            labels_format=self.labels_format,
        )

    def __call__(self, image, labels=None, return_inverter=False):
        self.random_crop.labels_format = self.labels_format
        return self.random_crop(image, labels, return_inverter)


class SSDExpand:
    """The original SSD expand: with prob 0.5, place the image uniformly on a
    1x-4x mean-color canvas ("zoom out" for small-object accuracy)."""

    def __init__(self, background=(123, 117, 104), labels_format=None):
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.expand = RandomPatch(
            patch_coord_generator=PatchCoordinateGenerator(
                must_match="h_w", min_scale=1.0, max_scale=4.0, scale_uniformly=True
            ),
            box_filter=None, image_validator=None, n_trials_max=1,
            clip_boxes=False, prob=0.5, background=background,
            labels_format=self.labels_format,
        )

    def __call__(self, image, labels=None, return_inverter=False):
        self.expand.labels_format = self.labels_format
        return self.expand(image, labels, return_inverter)


class SSDPhotometricDistortions:
    """The original SSD photometric pipeline: two order-variants (contrast
    before vs. after the HSV round trip), each chosen with probability 0.5."""

    def __init__(self):
        to3 = ConvertTo3Channels()
        to_f32 = ConvertDataType(to="float32")
        to_u8 = ConvertDataType(to="uint8")
        rgb2hsv = ConvertColor(current="RGB", to="HSV")
        hsv2rgb = ConvertColor(current="HSV", to="RGB")
        brightness = RandomBrightness(lower=-32, upper=32, prob=0.5)
        contrast = RandomContrast(lower=0.5, upper=1.5, prob=0.5)
        saturation = RandomSaturation(lower=0.5, upper=1.5, prob=0.5)
        hue = RandomHue(max_delta=18, prob=0.5)
        swap = RandomChannelSwap(prob=0.0)

        self.sequence1 = [to3, to_f32, brightness, contrast, to_u8, rgb2hsv,
                          to_f32, saturation, hue, to_u8, hsv2rgb, swap]
        self.sequence2 = [to3, to_f32, brightness, to_u8, rgb2hsv, to_f32,
                          saturation, hue, to_u8, hsv2rgb, to_f32, contrast,
                          to_u8, swap]

    def __call__(self, image, labels):
        sequence = self.sequence1 if np.random.choice(2) else self.sequence2
        for transform in sequence:
            image, labels = transform(image, labels)
        return image, labels


class SSDDataAugmentation(_Chain):
    """The full Caffe-faithful SSD train-time augmentation chain:
    photometric -> expand -> random crop -> random flip -> random-interp resize."""

    def __init__(self, img_height=300, img_width=300,
                 background=(123, 117, 104), labels_format=None):
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.photometric_distortions = SSDPhotometricDistortions()
        self.expand = SSDExpand(background=background, labels_format=self.labels_format)
        self.random_crop = SSDRandomCrop(labels_format=self.labels_format)
        self.random_flip = RandomFlip(dim="horizontal", prob=0.5,
                                      labels_format=self.labels_format)
        # Shrinking can collapse tiny boxes to zero size; drop those.
        self.box_filter = BoxFilter(
            check_overlap=False, check_min_area=False, check_degenerate=True,
            labels_format=self.labels_format,
        )
        self.resize = ResizeRandomInterp(
            height=img_height, width=img_width,
            box_filter=self.box_filter, labels_format=self.labels_format,
        )
        self.sequence = [self.photometric_distortions, self.expand,
                         self.random_crop, self.random_flip, self.resize]


class DataAugmentationConstantInputSize(_Chain):
    """Photometric + flip + translate + scale chain for fixed-size datasets
    (what ssd7_training uses). All transforms preserve the input size."""

    def __init__(
        self,
        random_brightness=(-48, 48, 0.5),
        random_contrast=(0.5, 1.8, 0.5),
        random_saturation=(0.5, 1.8, 0.5),
        random_hue=(18, 0.5),
        random_flip=0.5,
        random_translate=((0.03, 0.5), (0.03, 0.5), 0.5),
        random_scale=(0.5, 2.0, 0.5),
        n_trials_max=3,
        clip_boxes=True,
        overlap_criterion="area",
        bounds_box_filter=(0.3, 1.0),
        bounds_validator=(0.5, 1.0),
        n_boxes_min=1,
        background=(0, 0, 0),
        labels_format=None,
    ):
        if random_scale[0] >= 1 or random_scale[1] <= 1:
            raise ValueError(
                "random_scale must straddle 1 (min < 1 < max) for the "
                "zoom-in / zoom-out sequence split to make sense."
            )
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.box_filter = BoxFilter(
            check_overlap=True, check_min_area=False, check_degenerate=False,
            overlap_criterion=overlap_criterion, overlap_bounds=bounds_box_filter,
            labels_format=self.labels_format,
        )
        self.image_validator = ImageValidator(
            overlap_criterion=overlap_criterion, bounds=bounds_validator,
            n_boxes_min=n_boxes_min, labels_format=self.labels_format,
        )
        to3 = ConvertTo3Channels()
        to_f32 = ConvertDataType(to="float32")
        to_u8 = ConvertDataType(to="uint8")
        rgb2hsv = ConvertColor(current="RGB", to="HSV")
        hsv2rgb = ConvertColor(current="HSV", to="RGB")
        brightness = RandomBrightness(*random_brightness)
        contrast = RandomContrast(*random_contrast)
        saturation = RandomSaturation(*random_saturation)
        hue = RandomHue(*random_hue)
        flip = RandomFlip(dim="horizontal", prob=random_flip,
                          labels_format=self.labels_format)
        geo_kwargs = dict(
            clip_boxes=clip_boxes, box_filter=self.box_filter,
            image_validator=self.image_validator, n_trials_max=n_trials_max,
            background=background, labels_format=self.labels_format,
        )
        translate = RandomTranslate(
            dy_minmax=random_translate[0], dx_minmax=random_translate[1],
            prob=random_translate[2], **geo_kwargs,
        )
        zoom_in = RandomScale(min_factor=1.0, max_factor=random_scale[1],
                              prob=random_scale[2], **geo_kwargs)
        zoom_out = RandomScale(min_factor=random_scale[0], max_factor=1.0,
                               prob=random_scale[2], **geo_kwargs)
        # Two variants: zoom IN (translate before scaling) with the first
        # photometric order, zoom OUT (scaling before translating) with the
        # second — the reference's sequence pair (:122-153).
        self.sequence1 = [to3, to_f32, brightness, contrast, to_u8, rgb2hsv,
                          to_f32, saturation, hue, to_u8, hsv2rgb,
                          translate, zoom_in, flip]
        self.sequence2 = [to3, to_f32, brightness, to_u8, rgb2hsv, to_f32,
                          saturation, hue, to_u8, hsv2rgb, to_f32, contrast,
                          to_u8, zoom_out, translate, flip]

    def __call__(self, image, labels=None):
        sequence = self.sequence1 if np.random.choice(2) else self.sequence2
        self.sequence = sequence
        self._propagate_format()
        if labels is None:
            for transform in sequence:
                image = transform(image)
            return image
        for transform in sequence:
            image, labels = transform(image, labels)
        return image, labels


class DataAugmentationVariableInputSize(_Chain):
    """A faster rough approximation of the original SSD chain for datasets
    with variable image sizes: photometric + random patch (w_ar) + flip + resize."""

    def __init__(
        self,
        resize_height,
        resize_width,
        random_brightness=(-48, 48, 0.5),
        random_contrast=(0.5, 1.8, 0.5),
        random_saturation=(0.5, 1.8, 0.5),
        random_hue=(18, 0.5),
        random_flip=0.5,
        min_scale=0.3,
        max_scale=2.0,
        min_aspect_ratio=0.5,
        max_aspect_ratio=2.0,
        n_trials_max=3,
        clip_boxes=True,
        overlap_criterion="area",
        bounds_box_filter=(0.3, 1.0),
        bounds_validator=(0.5, 1.0),
        n_boxes_min=1,
        background=(0, 0, 0),
        labels_format=None,
    ):
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.box_filter = BoxFilter(
            check_overlap=True, check_min_area=False, check_degenerate=False,
            overlap_criterion=overlap_criterion, overlap_bounds=bounds_box_filter,
            labels_format=self.labels_format,
        )
        self.box_filter_resize = BoxFilter(
            check_overlap=False, check_min_area=True, check_degenerate=True,
            min_area=16, labels_format=self.labels_format,
        )
        self.image_validator = ImageValidator(
            overlap_criterion=overlap_criterion, bounds=bounds_validator,
            n_boxes_min=n_boxes_min, labels_format=self.labels_format,
        )
        patch_gen = PatchCoordinateGenerator(
            must_match="w_ar", min_scale=min_scale, max_scale=max_scale,
            min_aspect_ratio=min_aspect_ratio, max_aspect_ratio=max_aspect_ratio,
        )
        self.random_patch = RandomPatch(
            patch_coord_generator=patch_gen, box_filter=self.box_filter,
            image_validator=self.image_validator, n_trials_max=n_trials_max,
            clip_boxes=clip_boxes, prob=1.0, background=background,
            labels_format=self.labels_format,
        )
        self.flip = RandomFlip(dim="horizontal", prob=random_flip,
                               labels_format=self.labels_format)
        self.resize = Resize(height=resize_height, width=resize_width,
                             box_filter=self.box_filter_resize,
                             labels_format=self.labels_format)
        # One fixed photometric order (unlike 2.18's two variants), then
        # patch -> flip -> resize (…_variable_input_size.py:122-136).
        self.sequence = [
            ConvertTo3Channels(), ConvertDataType(to="float32"),
            RandomBrightness(*random_brightness), RandomContrast(*random_contrast),
            ConvertDataType(to="uint8"), ConvertColor(current="RGB", to="HSV"),
            ConvertDataType(to="float32"), RandomSaturation(*random_saturation),
            RandomHue(*random_hue), ConvertDataType(to="uint8"),
            ConvertColor(current="HSV", to="RGB"),
            self.random_patch, self.flip, self.resize,
        ]


class DataAugmentationSatellite(_Chain):
    """Augmentation for bird's-eye imagery: photometric + patch + both flips +
    right-angle rotations + resize."""

    def __init__(
        self,
        resize_height,
        resize_width,
        random_brightness=(-48, 48, 0.5),
        random_contrast=(0.5, 1.8, 0.5),
        random_saturation=(0.5, 1.8, 0.5),
        random_hue=(18, 0.5),
        random_flip=0.5,
        random_rotate=((90, 180, 270), 0.5),
        min_scale=0.3,
        max_scale=2.0,
        min_aspect_ratio=0.8,
        max_aspect_ratio=1.25,
        n_trials_max=3,
        clip_boxes=True,
        overlap_criterion="area",
        bounds_box_filter=(0.3, 1.0),
        bounds_validator=(0.5, 1.0),
        n_boxes_min=1,
        background=(0, 0, 0),
        labels_format=None,
    ):
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.box_filter = BoxFilter(
            check_overlap=True, check_min_area=False, check_degenerate=False,
            overlap_criterion=overlap_criterion, overlap_bounds=bounds_box_filter,
            labels_format=self.labels_format,
        )
        self.box_filter_resize = BoxFilter(
            check_overlap=False, check_min_area=True, check_degenerate=True,
            min_area=16, labels_format=self.labels_format,
        )
        self.image_validator = ImageValidator(
            overlap_criterion=overlap_criterion, bounds=bounds_validator,
            n_boxes_min=n_boxes_min, labels_format=self.labels_format,
        )
        patch_gen = PatchCoordinateGenerator(
            must_match="w_ar", min_scale=min_scale, max_scale=max_scale,
            min_aspect_ratio=min_aspect_ratio, max_aspect_ratio=max_aspect_ratio,
        )
        self.random_patch = RandomPatch(
            patch_coord_generator=patch_gen, box_filter=self.box_filter,
            image_validator=self.image_validator, n_trials_max=n_trials_max,
            clip_boxes=clip_boxes, prob=1.0, background=background,
            labels_format=self.labels_format,
        )
        self.hflip = RandomFlip(dim="horizontal", prob=random_flip,
                                labels_format=self.labels_format)
        self.vflip = RandomFlip(dim="vertical", prob=random_flip,
                                labels_format=self.labels_format)
        self.rotate = RandomRotate(angles=list(random_rotate[0]),
                                   prob=random_rotate[1],
                                   labels_format=self.labels_format)
        self.resize = Resize(height=resize_height, width=resize_width,
                             box_filter=self.box_filter_resize,
                             labels_format=self.labels_format)
        # Photometric -> both flips -> right-angle rotate -> patch -> resize
        # (…_satellite.py:125-140).
        self.sequence = [
            ConvertTo3Channels(), ConvertDataType(to="float32"),
            RandomBrightness(*random_brightness), RandomContrast(*random_contrast),
            ConvertDataType(to="uint8"), ConvertColor(current="RGB", to="HSV"),
            ConvertDataType(to="float32"), RandomSaturation(*random_saturation),
            RandomHue(*random_hue), ConvertDataType(to="uint8"),
            ConvertColor(current="HSV", to="RGB"),
            self.hflip, self.vflip, self.rotate, self.random_patch, self.resize,
        ]
