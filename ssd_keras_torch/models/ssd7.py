"""SSD7: a small 7-layer SSD trainable from scratch (PyTorch).

Port of ``ssd_keras_tpu/models/ssd7.py``: 7 Conv+BN+ELU blocks
(32/48/64/64/48/48/32 channels, 5x5 first kernel, 3x3 after, SAME padding),
2x2/2 VALID max pools (floor) after blocks 1-6, fused predictor heads on
conv4..conv7, and the reference's layer names (``conv{i}``, ``bn{i}``,
``classes{i}``, ``boxes{i}``). BatchNorm follows flax
(``models/layers.py:BatchNorm``). conv1 runs as a plain convolution: the JAX
package's space-to-depth form of it is a TPU rewrite with the same output.

With ``fold_bn=True`` the module has no BatchNorm layers and serves the
parameters of ``optimize.fold_batchnorm`` (each BN folded into its conv); it
is an inference-only graph and refuses ``train()`` mode, as the JAX
package's ``SSD7(fold_bn=True)`` refuses ``train=True``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.devices import target_device
from ssd_keras_torch.models.common import (
    SSDModule,
    apply_mode,
    assemble_predictions,
    init_weights,
)
from ssd_keras_torch.models.layers import BatchNorm, preprocess_input

__all__ = ["SSD7", "build_model", "ssd_7", "ssd7_predictor_sizes"]

_CHANNELS = (32, 48, 64, 64, 48, 48, 32)
_HEAD_LAYERS = (4, 5, 6, 7)


def ssd7_predictor_sizes(img_height: int, img_width: int) -> List[Tuple[int, int]]:
    """Static (fh, fw) of the 4 predictor layers (VALID 2x2 pools)."""
    h, w = img_height, img_width
    sizes = []
    for i in range(1, 8):
        if i >= 2:  # conv_i sees the input downsampled by pool_{i-1}
            h, w = h // 2, w // 2
        if i in _HEAD_LAYERS:
            sizes.append((h, w))
    if sizes[-1][0] < 1 or sizes[-1][1] < 1:
        raise ValueError(
            f"Input {img_height}x{img_width} is too small for SSD7's six 2x "
            "pools; both dimensions must be >= 64."
        )
    return sizes


class SSD7(SSDModule):
    """The SSD7 network; ``forward`` takes (B, H, W, 3) images. BatchNorm
    uses batch statistics in ``train()`` mode and the running ones in
    ``eval()`` mode. Parameters and BN statistics are f32; the convolutions
    run in ``compute_dtype``. ``fold_bn``: no BatchNorm layers (their
    affine maps folded into the convs by ``optimize.fold_batchnorm``),
    inference only."""

    def __init__(self, config: SSDConfig, mode: str = "training",
                 compute_dtype: torch.dtype = torch.float32, fold_bn: bool = False):
        super().__init__(config, mode, compute_dtype,
                         ssd7_predictor_sizes(config.img_height, config.img_width))
        cin = config.img_channels
        for i, ch in enumerate(_CHANNELS, start=1):
            k = 5 if i == 1 else 3
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, k, padding=k // 2))
            if not fold_bn:
                self.add_module(f"bn{i}", BatchNorm(ch))
            cin = ch
        n_classes = config.n_classes_with_background
        for layer, n_boxes in zip(_HEAD_LAYERS, config.n_boxes_per_cell):
            ch = _CHANNELS[layer - 1]
            self.add_module(f"classes{layer}", nn.Conv2d(ch, n_boxes * n_classes, 3, padding=1))
            self.add_module(f"boxes{layer}", nn.Conv2d(ch, n_boxes * 4, 3, padding=1))
        self.fold_bn = fold_bn
        if fold_bn:
            self.training = False

    def train(self, mode: bool = True):
        if mode and self.fold_bn:
            raise ValueError("fold_bn=True is an inference-only graph; "
                             "train with fold_bn=False.")
        return super().train(mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        consts = self._constants(x.device)
        x = preprocess_input(
            x.to(self.compute_dtype), consts["subtract_mean"], consts["divide_by_stddev"],
            consts["swap_channels"],
        ).permute(0, 3, 1, 2)
        conf_maps, loc_maps = [], []
        for i in range(1, len(_CHANNELS) + 1):
            x = self.conv(x, f"conv{i}")
            if not self.fold_bn:
                x = getattr(self, f"bn{i}")(x)
            x = F.elu(x)
            if i in _HEAD_LAYERS:
                conf_map, loc_map = self.heads(x, f"classes{i}", f"boxes{i}")
                conf_maps.append(conf_map)
                loc_maps.append(loc_map)
            if i < len(_CHANNELS):
                x = F.max_pool2d(x, 2, 2)
        predictions = assemble_predictions(
            conf_maps, loc_maps, consts["anchors"], cfg.n_classes_with_background
        )
        return apply_mode(predictions, self.mode, cfg)


def build_model(
    config: Optional[SSDConfig] = None,
    mode: str = "training",
    compute_dtype: torch.dtype = torch.float32,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    fold_bn: bool = False,
    **config_overrides,
):
    """Build an SSD7 model on ``device`` (the card unless the caller asks for
    the CPU; no card raises). Returns ``(module, predictor_sizes)``.

    Weights are drawn on the CPU from ``generator`` as in ``ssd_300`` and
    stay f32. With no ``config`` the canonical SSD7 configuration is used;
    ``config_overrides`` go to :meth:`SSDConfig.ssd7`. ``fold_bn=True``
    builds the BatchNorm-free serving graph for ``optimize.fold_batchnorm``'s
    parameters.
    """
    device = target_device(device)
    if config is None:
        config = SSDConfig.ssd7(**config_overrides)
    elif config_overrides:
        raise ValueError("Pass either a config or overrides, not both.")
    module = SSD7(config, mode=mode, compute_dtype=compute_dtype, fold_bn=fold_bn)
    init_weights(module, generator)
    module.to(device=device).eval()
    sizes = ssd7_predictor_sizes(config.img_height, config.img_width)
    return module, np.array(sizes)


ssd_7 = build_model
