"""Miscellaneous data-pipeline utilities.

Capability parity with
data_generator/object_detection_2d_misc_utils.py
(``apply_inverse_transforms`` :22).

Vendored from ``ssd_keras_tpu/data/misc.py`` (NumPy only) with only the import
paths changed, so that the PyTorch port imports without JAX.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["apply_inverse_transforms"]


def apply_inverse_transforms(
    y_pred_decoded: Sequence[np.ndarray],
    inverse_transforms: Sequence[Optional[Sequence]],
) -> List[np.ndarray]:
    """Map decoded predictions back to original-image coordinates.

    ``inverse_transforms[i]`` is the per-image list of inverter closures that
    the transforms emitted (in application order, reversed by the chain so the
    last transform is undone first); ``None`` entries are skipped.
    """
    y_pred_decoded_inv = []
    for i, preds in enumerate(y_pred_decoded):
        preds = np.copy(preds)
        if preds.size > 0:
            for inverter in inverse_transforms[i]:
                if inverter is not None:
                    preds = inverter(preds)
        y_pred_decoded_inv.append(preds)
    return y_pred_decoded_inv
