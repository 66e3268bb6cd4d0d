"""Axis-aligned box coordinate helpers for the PyTorch port.

``border_delta`` and ``convert_coordinates`` are vendored from
``ssd_keras_tpu/ops/boxes.py``; ``convert_coordinates`` takes a NumPy array
(the anchor generator) or a torch tensor (the target encoder), with one set
of formulas for both. ``intersection_area`` and ``iou`` are the torch
counterparts of the JAX functions of the same names, which the encoder runs
on the device. Every step is one elementwise op, as in NumPy.
``intersection_area_np`` and ``iou_np`` are the JAX functions with
``xp=np`` (the host decoders', box filters' and evaluator's IoU).

Coordinate formats
------------------
* ``'minmax'``:    (xmin, xmax, ymin, ymax)
* ``'corners'``:   (xmin, ymin, xmax, ymax)
* ``'centroids'``: (cx, cy, w, h)

``border_pixels`` semantics (``d`` offset added to every width/height
difference): ``'half'`` -> 0, ``'include'`` -> +1, ``'exclude'`` -> -1.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "border_delta", "convert_coordinates", "convert_coordinates2", "corner_indices",
    "intersection_area", "iou", "intersection_area_np", "iou_np",
]

_CONVERSIONS = {
    "minmax2centroids",
    "centroids2minmax",
    "corners2centroids",
    "centroids2corners",
    "minmax2corners",
    "corners2minmax",
}


def border_delta(border_pixels: str) -> int:
    """Map a border-pixel convention to its width/height delta."""
    try:
        return {"half": 0, "include": 1, "exclude": -1}[border_pixels]
    except KeyError:
        raise ValueError(
            "`border_pixels` must be one of 'half', 'include', 'exclude', "
            f"got {border_pixels!r}."
        )


def corner_indices(coords: str):
    """Return (xmin, ymin, xmax, ymax) index positions for a coordinate format."""
    if coords == "corners":
        return 0, 1, 2, 3
    if coords == "minmax":
        return 0, 2, 1, 3
    raise ValueError(f"Expected 'corners' or 'minmax', got {coords!r}.")


def convert_coordinates(tensor, start_index, conversion, border_pixels="half"):
    """Convert 4 consecutive box coordinates in the last axis between formats.

    Returns a new array (a tensor for a tensor input) with the converted
    coordinates written over positions ``start_index:start_index+4`` of the
    last axis; all other elements of the last axis are preserved. Supports
    negative ``start_index``.
    """
    if conversion not in _CONVERSIONS:
        raise ValueError(
            f"Unexpected conversion value {conversion!r}. Supported: {sorted(_CONVERSIONS)}."
        )
    d = border_delta(border_pixels)

    is_torch = isinstance(tensor, torch.Tensor)
    if not is_torch:
        tensor = np.asarray(tensor)
    ind = start_index if start_index >= 0 else tensor.shape[-1] + start_index
    a = tensor[..., ind + 0]
    b = tensor[..., ind + 1]
    c = tensor[..., ind + 2]
    e = tensor[..., ind + 3]

    if conversion == "minmax2centroids":  # (xmin,xmax,ymin,ymax) -> (cx,cy,w,h)
        out = ((a + b) / 2.0, (c + e) / 2.0, b - a + d, e - c + d)
    elif conversion == "centroids2minmax":  # (cx,cy,w,h) -> (xmin,xmax,ymin,ymax)
        out = (a - c / 2.0, a + c / 2.0, b - e / 2.0, b + e / 2.0)
    elif conversion == "corners2centroids":  # (xmin,ymin,xmax,ymax) -> (cx,cy,w,h)
        out = ((a + c) / 2.0, (b + e) / 2.0, c - a + d, e - b + d)
    elif conversion == "centroids2corners":  # (cx,cy,w,h) -> (xmin,ymin,xmax,ymax)
        out = (a - c / 2.0, b - e / 2.0, a + c / 2.0, b + e / 2.0)
    else:  # minmax<->corners: swap the middle two coordinates
        out = (a, c, b, e)

    if is_torch:
        converted = torch.stack(out, dim=-1)
        return torch.cat(
            [
                tensor[..., :ind].to(converted.dtype),
                converted,
                tensor[..., ind + 4 :].to(converted.dtype),
            ],
            dim=-1,
        )
    converted = np.stack(out, axis=-1)
    return np.concatenate(
        [
            tensor[..., :ind].astype(converted.dtype),
            converted,
            tensor[..., ind + 4 :].astype(converted.dtype),
        ],
        axis=-1,
    )


_M_MINMAX2CENTROIDS = np.array(
    [[0.5, 0.0, -1.0, 0.0],
     [0.5, 0.0, 1.0, 0.0],
     [0.0, 0.5, 0.0, -1.0],
     [0.0, 0.5, 0.0, 1.0]]
)
_M_CENTROIDS2MINMAX = np.array(
    [[1.0, 1.0, 0.0, 0.0],
     [0.0, 0.0, 1.0, 1.0],
     [-0.5, 0.5, 0.0, 0.0],
     [0.0, 0.0, -0.5, 0.5]]
)


def convert_coordinates2(tensor, start_index, conversion):
    """Matrix-multiplication variant of :func:`convert_coordinates`.

    Supports 'minmax2centroids' and 'centroids2minmax' only (the two
    conversions expressible as one linear map). Takes a NumPy array or a
    torch tensor, as :func:`convert_coordinates` does.
    """
    if conversion == "minmax2centroids":
        m = _M_MINMAX2CENTROIDS
    elif conversion == "centroids2minmax":
        m = _M_CENTROIDS2MINMAX
    else:
        raise ValueError(
            "Supported conversions: 'minmax2centroids', 'centroids2minmax'; "
            f"got {conversion!r}."
        )
    is_torch = isinstance(tensor, torch.Tensor)
    if not is_torch:
        tensor = np.asarray(tensor)
    ind = start_index if start_index >= 0 else tensor.shape[-1] + start_index
    if is_torch:
        converted = tensor[..., ind: ind + 4] @ torch.as_tensor(m, dtype=tensor.dtype,
                                                                device=tensor.device)
        return torch.cat([tensor[..., :ind].to(converted.dtype), converted,
                          tensor[..., ind + 4:].to(converted.dtype)], dim=-1)
    converted = tensor[..., ind: ind + 4] @ np.asarray(m, dtype=tensor.dtype)
    return np.concatenate([tensor[..., :ind].astype(converted.dtype), converted,
                           tensor[..., ind + 4:].astype(converted.dtype)], axis=-1)


def _split_corners(boxes, coords):
    xmin, ymin, xmax, ymax = corner_indices(coords)
    return boxes[..., xmin], boxes[..., ymin], boxes[..., xmax], boxes[..., ymax]


def _as_boxes(boxes1, boxes2, coords):
    """Tensors with a leading box axis, in 'corners' or 'minmax' format."""
    boxes1, boxes2 = torch.as_tensor(boxes1), torch.as_tensor(boxes2)
    if boxes1.dim() == 1:
        boxes1 = boxes1[None, :]
    if boxes2.dim() == 1:
        boxes2 = boxes2[None, :]
    if coords == "centroids":
        boxes1 = convert_coordinates(boxes1, 0, "centroids2corners")
        boxes2 = convert_coordinates(boxes2, 0, "centroids2corners")
        coords = "corners"
    elif coords not in ("minmax", "corners"):
        raise ValueError(
            f"Unexpected value for `coords`: {coords!r}. "
            "Supported: 'minmax', 'corners', 'centroids'."
        )
    return boxes1, boxes2, coords


def _outer(mode, first, second):
    """Broadcast per-box values of two sets against each other."""
    if mode == "outer_product":
        return [t[..., :, None] for t in first], [t[..., None, :] for t in second]
    if mode != "element-wise":
        raise ValueError(f"`mode` must be 'outer_product' or 'element-wise', got {mode!r}.")
    return first, second


def intersection_area(
    boxes1, boxes2, coords="corners", mode="outer_product", border_pixels="half"
):
    """Intersection areas between two box sets (torch tensors).

    ``mode='outer_product'``: boxes1 ``(..., m, 4)``, boxes2 ``(..., n, 4)``
    -> ``(..., m, n)``. ``mode='element-wise'``: broadcast-compatible shapes
    -> elementwise areas. ``coords`` may be 'corners', 'minmax', or
    'centroids' (converted internally).
    """
    boxes1, boxes2, coords = _as_boxes(boxes1, boxes2, coords)
    d = border_delta(border_pixels)
    (x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b) = _outer(
        mode, _split_corners(boxes1, coords), _split_corners(boxes2, coords)
    )
    iw = torch.clamp_min(torch.minimum(x2a, x2b) - torch.maximum(x1a, x1b) + d, 0.0)
    ih = torch.clamp_min(torch.minimum(y2a, y2b) - torch.maximum(y1a, y1b) + d, 0.0)
    return iw * ih


def iou(boxes1, boxes2, coords="centroids", mode="outer_product", border_pixels="half"):
    """Jaccard (IoU) similarity between two box sets. See ``intersection_area``."""
    boxes1, boxes2, coords = _as_boxes(boxes1, boxes2, coords)
    # As in the JAX package (and its reference): the intersection always uses
    # the 'half' convention, the union areas use ``border_pixels``.
    inter = intersection_area(boxes1, boxes2, coords=coords, mode=mode, border_pixels="half")
    d = border_delta(border_pixels)
    x1a, y1a, x2a, y2a = _split_corners(boxes1, coords)
    x1b, y1b, x2b, y2b = _split_corners(boxes2, coords)
    (area1,), (area2,) = _outer(
        mode, ((x2a - x1a + d) * (y2a - y1a + d),), ((x2b - x1b + d) * (y2b - y1b + d),)
    )
    return inter / (area1 + area2 - inter)


# --------------------------------------------------------------------------- #
# NumPy (host) IoU, vendored from ``ssd_keras_tpu/ops/boxes.py`` with
# ``xp=np``: the host decoders, the data pipeline's box filter and the
# evaluator's matching use these, in NumPy's own dtypes and op order, so that
# a decision at an IoU threshold falls as it does in the JAX package.
# --------------------------------------------------------------------------- #


def _as_boxes_np(boxes1, boxes2, coords):
    """``_as_boxes`` for NumPy arrays."""
    boxes1, boxes2 = np.asarray(boxes1), np.asarray(boxes2)
    if boxes1.ndim == 1:
        boxes1 = boxes1[None, :]
    if boxes2.ndim == 1:
        boxes2 = boxes2[None, :]
    if coords == "centroids":
        boxes1 = convert_coordinates(boxes1, 0, "centroids2corners")
        boxes2 = convert_coordinates(boxes2, 0, "centroids2corners")
        coords = "corners"
    elif coords not in ("minmax", "corners"):
        raise ValueError(
            f"Unexpected value for `coords`: {coords!r}. "
            "Supported: 'minmax', 'corners', 'centroids'."
        )
    return boxes1, boxes2, coords


def intersection_area_np(
    boxes1, boxes2, coords="corners", mode="outer_product", border_pixels="half"
):
    """NumPy intersection areas between two box sets; see ``intersection_area``."""
    boxes1, boxes2, coords = _as_boxes_np(boxes1, boxes2, coords)
    d = border_delta(border_pixels)
    (x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b) = _outer(
        mode, _split_corners(boxes1, coords), _split_corners(boxes2, coords)
    )
    iw = np.maximum(0.0, np.minimum(x2a, x2b) - np.maximum(x1a, x1b) + d)
    ih = np.maximum(0.0, np.minimum(y2a, y2b) - np.maximum(y1a, y1b) + d)
    return iw * ih


def iou_np(boxes1, boxes2, coords="centroids", mode="outer_product", border_pixels="half"):
    """NumPy Jaccard (IoU) similarity between two box sets; see ``iou``."""
    boxes1, boxes2, coords = _as_boxes_np(boxes1, boxes2, coords)
    inter = intersection_area_np(boxes1, boxes2, coords=coords, mode=mode, border_pixels="half")
    d = border_delta(border_pixels)
    x1a, y1a, x2a, y2a = _split_corners(boxes1, coords)
    x1b, y1b, x2b, y2b = _split_corners(boxes2, coords)
    (area1,), (area2,) = _outer(
        mode, ((x2a - x1a + d) * (y2a - y1a + d),), ((x2b - x1b + d) * (y2b - y1b + d),)
    )
    return inter / (area1 + area2 - inter)
