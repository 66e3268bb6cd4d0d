"""Box/image validity utilities for the augmentation pipeline.

Capability parity with
data_generator/object_detection_2d_image_boxes_validation_utils.py
(``BoundGenerator`` :28, ``BoxFilter`` :79, ``ImageValidator`` :234).

Vendored from ``ssd_keras_tpu/data/validation.py`` (NumPy only) with only the import
paths changed (``box_ops.iou`` with ``xp=np`` is ``box_ops.iou_np`` here), so
that the PyTorch port imports without JAX.

These are host-side (NumPy) components: they gate the *control flow* of random
patch sampling, which is inherently data-dependent; the heavy per-pixel work
happens elsewhere (on device or in OpenCV's native kernels).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ssd_keras_torch.ops import boxes as box_ops

__all__ = ["BoundGenerator", "BoxFilter", "ImageValidator", "DEFAULT_LABELS_FORMAT"]

DEFAULT_LABELS_FORMAT = {"class_id": 0, "xmin": 1, "ymin": 2, "xmax": 3, "ymax": 4}


class BoundGenerator:
    """Randomly picks a (lower, upper) bound pair from a sample space.

    ``None`` entries mean 0.0 (lower) / 1.0 (upper).
    """

    def __init__(
        self,
        sample_space=((0.1, None), (0.3, None), (0.5, None), (0.7, None), (0.9, None), (None, None)),
        weights: Optional[Sequence[float]] = None,
    ):
        if weights is not None and len(weights) != len(sample_space):
            raise ValueError("`weights` must be None or match the sample space length.")
        self.sample_space = []
        for pair in sample_space:
            if len(pair) != 2:
                raise ValueError("All sample space elements must be 2-tuples.")
            lo = 0.0 if pair[0] is None else float(pair[0])
            hi = 1.0 if pair[1] is None else float(pair[1])
            if lo > hi:
                raise ValueError("Lower bound cannot exceed upper bound.")
            self.sample_space.append((lo, hi))
        n = len(self.sample_space)
        self.weights = list(weights) if weights is not None else [1.0 / n] * n

    def __call__(self) -> Tuple[float, float]:
        i = np.random.choice(len(self.sample_space), p=self.weights)
        return self.sample_space[i]


class BoxFilter:
    """Keeps boxes that pass degeneracy / min-area / image-overlap checks.

    ``overlap_criterion``: 'center_point' (box center inside the image),
    'iou' (IoU of box with the whole image within bounds), or 'area'
    (intersection/box-area quotient within bounds, with the reference's
    careful zero-lower-bound edge case).
    """

    def __init__(
        self,
        check_overlap: bool = True,
        check_min_area: bool = True,
        check_degenerate: bool = True,
        overlap_criterion: str = "center_point",
        overlap_bounds: Union[Tuple[float, float], BoundGenerator] = (0.3, 1.0),
        min_area: int = 16,
        labels_format=None,
        border_pixels: str = "half",
    ):
        if overlap_criterion not in ("iou", "area", "center_point"):
            raise ValueError("`overlap_criterion` must be 'iou', 'area', or 'center_point'.")
        if isinstance(overlap_bounds, (list, tuple)) and overlap_bounds[0] > overlap_bounds[1]:
            raise ValueError("The lower bound must not exceed the upper bound.")
        self.check_overlap = check_overlap
        self.check_min_area = check_min_area
        self.check_degenerate = check_degenerate
        self.overlap_criterion = overlap_criterion
        self.overlap_bounds = overlap_bounds
        self.min_area = min_area
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.border_pixels = border_pixels

    def __call__(self, labels, image_height=None, image_width=None):
        labels = np.copy(labels)
        fx = self.labels_format
        xmin, ymin = fx["xmin"], fx["ymin"]
        xmax, ymax = fx["xmax"], fx["ymax"]
        w = labels[:, xmax] - labels[:, xmin]
        h = labels[:, ymax] - labels[:, ymin]

        ok = np.ones(labels.shape[0], dtype=bool)
        if self.check_degenerate:
            ok &= (w > 0) & (h > 0)
        if self.check_min_area:
            ok &= w * h >= self.min_area

        if self.check_overlap:
            if isinstance(self.overlap_bounds, BoundGenerator):
                lower, upper = self.overlap_bounds()
            else:
                lower, upper = self.overlap_bounds

            if self.overlap_criterion == "iou":
                image_box = np.array([0, 0, image_width, image_height])
                ious = box_ops.iou_np(
                    image_box,
                    labels[:, [xmin, ymin, xmax, ymax]],
                    coords="corners",
                    mode="element-wise",
                    border_pixels=self.border_pixels,
                )
                ok &= (ious > lower) & (ious <= upper)
            elif self.overlap_criterion == "area":
                d = box_ops.border_delta(self.border_pixels)
                areas = (w + d) * (h + d)
                cx1 = np.clip(labels[:, xmin], 0, image_width - 1)
                cx2 = np.clip(labels[:, xmax], 0, image_width - 1)
                cy1 = np.clip(labels[:, ymin], 0, image_height - 1)
                cy2 = np.clip(labels[:, ymax], 0, image_height - 1)
                inter = (cx2 - cx1 + d) * (cy2 - cy1 + d)
                # Strict ">" at a zero lower bound so zero-intersection boxes
                # never pass; ">=" otherwise so `lower == 1` can be satisfied.
                lower_ok = inter > lower * areas if lower == 0.0 else inter >= lower * areas
                ok &= lower_ok & (inter <= upper * areas)
            else:  # center_point
                cx = (labels[:, xmin] + labels[:, xmax]) / 2
                cy = (labels[:, ymin] + labels[:, ymax]) / 2
                ok &= (cx >= 0.0) & (cx <= image_width - 1) & (cy >= 0.0) & (cy <= image_height - 1)

        return labels[ok]


class ImageValidator:
    """An image size is valid if enough boxes pass a ``BoxFilter`` overlap check."""

    def __init__(
        self,
        overlap_criterion: str = "center_point",
        bounds=(0.3, 1.0),
        n_boxes_min: Union[int, str] = 1,
        labels_format=None,
        border_pixels: str = "half",
    ):
        if not ((isinstance(n_boxes_min, int) and n_boxes_min > 0) or n_boxes_min == "all"):
            raise ValueError("`n_boxes_min` must be a positive integer or 'all'.")
        self.overlap_criterion = overlap_criterion
        self.bounds = bounds
        self.n_boxes_min = n_boxes_min
        self.labels_format = dict(labels_format or DEFAULT_LABELS_FORMAT)
        self.border_pixels = border_pixels
        self.box_filter = BoxFilter(
            check_overlap=True,
            check_min_area=False,
            check_degenerate=False,
            overlap_criterion=overlap_criterion,
            overlap_bounds=bounds,
            labels_format=self.labels_format,
            border_pixels=border_pixels,
        )

    def __call__(self, labels, image_height, image_width) -> bool:
        self.box_filter.overlap_bounds = self.bounds
        self.box_filter.labels_format = self.labels_format
        valid = self.box_filter(labels, image_height=image_height, image_width=image_width)
        if self.n_boxes_min == "all":
            return len(valid) == len(labels)
        return len(valid) >= self.n_boxes_min
