"""The program under test, ``ssd_keras_torch``, as the benchmark builds it
from a configuration file: its ``SSDConfig`` and a model holding the
benchmark's seeded weights, from the builder its architecture file names."""

from __future__ import annotations

import importlib
from typing import Dict

import torch

from perfbench.reference.ssd import architecture
from ssd_keras_torch.config import SSDConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The configuration file's keys that are fields of SSDConfig.
_FIELDS = ("img_height", "img_width", "img_channels", "n_classes", "scales", "aspect_ratios",
           "two_boxes_for_ar1", "steps", "offsets", "variances", "subtract_mean",
           "swap_channels", "matching_type", "pos_iou_threshold", "neg_iou_limit",
           "confidence_thresh", "iou_threshold", "top_k",
           "nms_max_output_size")


def ssd_config(config: dict) -> SSDConfig:
    return SSDConfig(**{k: config[k] for k in _FIELDS})


def model(config: dict, mode: str, weights: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The port's network for ``config`` in ``mode`` on ``device``, from the
    builder its architecture file names, its parameters loaded from
    ``weights``."""
    where, name = architecture(config).PORT_BUILDER.split(":")
    module, _ = getattr(importlib.import_module(where), name)(
        ssd_config(config), mode=mode, compute_dtype=DTYPES[config["compute_dtype"]],
        device=device)
    module.load_state_dict(weights, strict=True)
    return module
