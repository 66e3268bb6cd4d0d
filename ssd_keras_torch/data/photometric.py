"""Photometric (color-space) transforms, host-side.

Vendored from ``ssd_keras_tpu/data/photometric.py``: only
``ConvertTo3Channels``, the one transform of the evaluation path. The rest of
that module runs through OpenCV, which the port does not use; it comes with
the host augmentation chains' slice.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ConvertTo3Channels"]


def _ret(image, labels):
    return image if labels is None else (image, labels)


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
