"""Shared SSD head assembly and the model-output contract (PyTorch).

Port of ``ssd_keras_tpu/models/common.py``. The prediction tensor layout is
the cross-module contract (identical to the reference):

``(batch, total_boxes, n_classes + 4 + 8)`` =
``[softmaxed class confidences | 4 box offsets | 4 anchor coords | 4 variances]``

with boxes ordered as the C-order flatten of each predictor layer's
``(fh, fw, n_boxes_per_cell)`` grid (NHWC), layers concatenated in order.
"""

from __future__ import annotations

from typing import List

import torch

from ssd_keras_torch import decoder as decoder_mod
from ssd_keras_torch.config import SSDConfig

__all__ = [
    "assemble_predictions",
    "apply_mode",
    "same_pool_size",
    "valid_size",
    "validate_mode",
]


def same_pool_size(s: int) -> int:
    """Output size of a stride-2 'SAME' pool."""
    return -(-s // 2)


def valid_size(s: int, kernel: int, stride: int = 1, pad: int = 0) -> int:
    """Output size of a VALID conv with optional symmetric zero padding."""
    return (s + 2 * pad - kernel) // stride + 1


def assemble_predictions(
    conf_maps: List[torch.Tensor],
    loc_maps: List[torch.Tensor],
    anchors8: torch.Tensor,
    n_classes_with_bg: int,
) -> torch.Tensor:
    """Reshape + concatenate head outputs and append the anchor constants.

    ``conf_maps[i]``: (B, fh, fw, n_boxes*C) NHWC; ``loc_maps[i]``:
    (B, fh, fw, n_boxes*4); ``anchors8``: (N, 8) f32 on the maps' device.
    Output is float32 regardless of compute dtype (softmax in f32).
    """
    b = conf_maps[0].shape[0]
    conf = torch.cat([m.reshape(b, -1, n_classes_with_bg) for m in conf_maps], dim=1)
    loc = torch.cat([m.reshape(b, -1, 4) for m in loc_maps], dim=1)
    conf = torch.softmax(conf.float(), dim=-1)
    anchors = anchors8.expand(b, *anchors8.shape)
    return torch.cat([conf, loc.float(), anchors], dim=2)


def validate_mode(mode: str) -> str:
    """Reject unknown modes at build time, like the reference builders do."""
    if mode not in ("training", "inference", "inference_fast"):
        raise ValueError(
            f"`mode` must be 'training', 'inference' or 'inference_fast', "
            f"got {mode!r}."
        )
    return mode


def apply_mode(predictions: torch.Tensor, mode: str, config: SSDConfig) -> torch.Tensor:
    """Append the decode stage for 'inference' / 'inference_fast' modes."""
    if mode == "training":
        return predictions
    kwargs = dict(
        confidence_thresh=config.confidence_thresh,
        iou_threshold=config.iou_threshold,
        top_k=config.top_k,
        nms_max_output_size=config.nms_max_output_size,
        input_coords=config.coords,
        normalize_coords=config.normalize_coords,
        img_height=config.img_height,
        img_width=config.img_width,
    )
    if mode == "inference":
        return decoder_mod.decode_detections_fixed(predictions, **kwargs)
    if mode == "inference_fast":
        return decoder_mod.decode_detections_fast_fixed(predictions, **kwargs)
    raise ValueError(
        f"`mode` must be 'training', 'inference' or 'inference_fast', got {mode!r}."
    )
