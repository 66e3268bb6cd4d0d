"""Anchor ("prior") box generation — the single source of truth.

Vendored unchanged from ``ssd_keras_tpu/ops/anchors.py`` (NumPy only), so that
the PyTorch port imports without JAX; the two must stay identical, which
``tests/test_torch_models.py`` checks on the SSD300 anchor tensor.

The reference computes anchor grids twice with duplicated logic (once in the
``SSDInputEncoder`` at ssd_encoder_decoder/ssd_input_encoder.py:420-548 and
once inside the ``AnchorBoxes`` Keras layer at
keras_layers/keras_layer_AnchorBoxes.py:133-255). Here the grid is computed
exactly once, in NumPy at configuration time (anchors are a pure function of
model config, not of data), and reused by the model (as a constant folded
into the prediction tensor) and the decoder.

All arrays are float64 NumPy for bit-stable goldens; callers cast to the
compute dtype at the device boundary.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ssd_keras_torch.ops.boxes import convert_coordinates

__all__ = [
    "n_boxes_per_cell",
    "anchor_wh_for_layer",
    "anchor_grid_for_layer",
    "AnchorLayerDiagnostics",
    "build_anchor_tensor",
]

StepLike = Union[None, int, float, Tuple[float, float], List[float]]


def n_boxes_per_cell(aspect_ratios: Sequence[float], two_boxes_for_ar1: bool) -> int:
    """Number of anchor boxes per feature-map cell for one predictor layer."""
    n = len(aspect_ratios)
    if (1 in aspect_ratios) and two_boxes_for_ar1:
        n += 1
    return n


def anchor_wh_for_layer(
    img_height: int,
    img_width: int,
    aspect_ratios: Sequence[float],
    this_scale: float,
    next_scale: float,
    two_boxes_for_ar1: bool = True,
) -> np.ndarray:
    """Per-aspect-ratio (width, height) anchor sizes in pixels, shape (n_boxes, 2).

    Sizes scale the *shorter* image side. For ar == 1 an extra box with scale
    sqrt(this_scale * next_scale) is appended directly after the regular one
    when ``two_boxes_for_ar1`` (the Caffe-SSD "geomean" box).
    """
    size = min(img_height, img_width)
    wh = []
    for ar in aspect_ratios:
        if ar == 1:
            wh.append((this_scale * size, this_scale * size))
            if two_boxes_for_ar1:
                s = np.sqrt(this_scale * next_scale) * size
                wh.append((s, s))
        else:
            wh.append((this_scale * size * np.sqrt(ar), this_scale * size / np.sqrt(ar)))
    return np.array(wh, dtype=np.float64)


@dataclasses.dataclass
class AnchorLayerDiagnostics:
    """Introspection data for one predictor layer's anchor grid."""

    centers_cy: np.ndarray
    centers_cx: np.ndarray
    wh: np.ndarray
    step: Tuple[float, float]
    offset: Tuple[float, float]


def _resolve_pair(value: StepLike, default: Tuple[float, float]) -> Tuple[float, float]:
    if value is None:
        return default
    if isinstance(value, (list, tuple)):
        if len(value) != 2:
            raise ValueError(f"Expected a 2-element step/offset pair, got {value!r}.")
        return float(value[0]), float(value[1])
    return float(value), float(value)


def anchor_grid_for_layer(
    img_height: int,
    img_width: int,
    feature_map_size: Tuple[int, int],
    aspect_ratios: Sequence[float],
    this_scale: float,
    next_scale: float,
    two_boxes_for_ar1: bool = True,
    this_steps: StepLike = None,
    this_offsets: StepLike = None,
    clip_boxes: bool = False,
    normalize_coords: bool = True,
    coords: str = "centroids",
    diagnostics: bool = False,
):
    """Anchor grid for one predictor layer.

    Returns an array of shape ``(fh, fw, n_boxes, 4)`` in the requested
    ``coords`` format ('centroids', 'corners', or 'minmax'). Center points are
    ``linspace(offset*step, (offset + f - 1)*step, f)`` per axis; clipping (if
    enabled) happens in corner space against the pixel image bounds;
    normalization divides x by img_width and y by img_height.
    """
    fh, fw = int(feature_map_size[0]), int(feature_map_size[1])
    wh = anchor_wh_for_layer(
        img_height, img_width, aspect_ratios, this_scale, next_scale, two_boxes_for_ar1
    )
    n_boxes = wh.shape[0]

    step_h, step_w = _resolve_pair(this_steps, (img_height / fh, img_width / fw))
    off_h, off_w = _resolve_pair(this_offsets, (0.5, 0.5))

    cy = np.linspace(off_h * step_h, (off_h + fh - 1) * step_h, fh)
    cx = np.linspace(off_w * step_w, (off_w + fw - 1) * step_w, fw)
    cx_grid, cy_grid = np.meshgrid(cx, cy)

    boxes = np.zeros((fh, fw, n_boxes, 4), dtype=np.float64)
    boxes[..., 0] = cx_grid[..., None]
    boxes[..., 1] = cy_grid[..., None]
    boxes[..., 2] = wh[:, 0]
    boxes[..., 3] = wh[:, 1]

    boxes = convert_coordinates(boxes, 0, "centroids2corners")

    if clip_boxes:
        # Clip x into [0, img_width - 1] and y into [0, img_height - 1].
        boxes[..., [0, 2]] = np.clip(boxes[..., [0, 2]], 0.0, None)
        boxes[..., [0, 2]] = np.where(
            boxes[..., [0, 2]] >= img_width, img_width - 1, boxes[..., [0, 2]]
        )
        boxes[..., [1, 3]] = np.clip(boxes[..., [1, 3]], 0.0, None)
        boxes[..., [1, 3]] = np.where(
            boxes[..., [1, 3]] >= img_height, img_height - 1, boxes[..., [1, 3]]
        )

    if normalize_coords:
        boxes[..., [0, 2]] /= img_width
        boxes[..., [1, 3]] /= img_height

    if coords == "centroids":
        boxes = convert_coordinates(boxes, 0, "corners2centroids", border_pixels="half")
    elif coords == "minmax":
        boxes = convert_coordinates(boxes, 0, "corners2minmax")
    elif coords != "corners":
        raise ValueError(f"Unsupported coords {coords!r}.")

    if diagnostics:
        return boxes, AnchorLayerDiagnostics(
            centers_cy=cy, centers_cx=cx, wh=wh, step=(step_h, step_w), offset=(off_h, off_w)
        )
    return boxes


def build_anchor_tensor(
    img_height: int,
    img_width: int,
    predictor_sizes: Sequence[Tuple[int, int]],
    aspect_ratios_per_layer: Sequence[Sequence[float]],
    scales: Sequence[float],
    two_boxes_for_ar1: bool = True,
    steps: Optional[Sequence[StepLike]] = None,
    offsets: Optional[Sequence[StepLike]] = None,
    clip_boxes: bool = False,
    variances: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
    normalize_coords: bool = True,
    coords: str = "centroids",
) -> np.ndarray:
    """Flattened anchors-plus-variances tensor for a whole model.

    Returns shape ``(total_boxes, 8)`` where the last axis is the 4 anchor
    coordinates (in ``coords`` format) followed by the 4 variances. The box
    ordering is C-order flatten of ``(fh, fw, n_boxes)`` per layer, layers
    concatenated in order — identical to the reshape-then-concatenate order of
    the model's prediction tensor (ssd_input_encoder.py:550-611 documents why
    this ordering is the layout contract).
    """
    n_layers = len(predictor_sizes)
    if len(scales) != n_layers + 1:
        raise ValueError(f"len(scales) must be {n_layers + 1}, got {len(scales)}.")
    if len(aspect_ratios_per_layer) != n_layers:
        raise ValueError("One aspect-ratio list per predictor layer is required.")
    steps = [None] * n_layers if steps is None else list(steps)
    offsets = [None] * n_layers if offsets is None else list(offsets)
    variances = np.asarray(variances, dtype=np.float64)
    if variances.shape != (4,) or np.any(variances <= 0):
        raise ValueError(f"4 positive variances required, got {variances}.")

    per_layer = []
    for i in range(n_layers):
        grid = anchor_grid_for_layer(
            img_height,
            img_width,
            predictor_sizes[i],
            aspect_ratios_per_layer[i],
            scales[i],
            scales[i + 1],
            two_boxes_for_ar1=two_boxes_for_ar1,
            this_steps=steps[i],
            this_offsets=offsets[i],
            clip_boxes=clip_boxes,
            normalize_coords=normalize_coords,
            coords=coords,
        )
        per_layer.append(grid.reshape(-1, 4))
    boxes = np.concatenate(per_layer, axis=0)
    var = np.broadcast_to(variances, boxes.shape).copy()
    return np.concatenate([boxes, var], axis=1)
