"""Axis-aligned box coordinate helpers (NumPy), vendored for the PyTorch port.

The two functions the anchor generator and the decoder need, copied from
``ssd_keras_tpu/ops/boxes.py`` with their NumPy path only, so that the port
imports without JAX.

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

__all__ = ["border_delta", "convert_coordinates"]

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


def convert_coordinates(tensor, start_index, conversion, border_pixels="half"):
    """Convert 4 consecutive box coordinates in the last axis between formats.

    Returns a new array with the converted coordinates written over positions
    ``start_index:start_index+4`` of the last axis; all other elements of the
    last axis are preserved. Supports negative ``start_index``.
    """
    if conversion not in _CONVERSIONS:
        raise ValueError(
            f"Unexpected conversion value {conversion!r}. Supported: {sorted(_CONVERSIONS)}."
        )
    d = border_delta(border_pixels)

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

    converted = np.stack(out, axis=-1)
    return np.concatenate(
        [
            tensor[..., :ind].astype(converted.dtype),
            converted,
            tensor[..., ind + 4 :].astype(converted.dtype),
        ],
        axis=-1,
    )
