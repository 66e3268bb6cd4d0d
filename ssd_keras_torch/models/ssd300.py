"""SSD300: VGG-16 backbone + extras + multibox heads (PyTorch).

Port of ``ssd_keras_tpu/models/ssd300.py``: the same topology (VGG-16
conv1_1..pool5, dilated fc6, fc7, conv6..conv9 extras, L2-normalised conv4_3,
6 predictor layers, 8732 anchors at 300x300), the same layer names (so
``weights_io`` maps flax and Keras weights by name) and the same prediction
tensor layout. Images come in as (B, H, W, 3), as in the JAX package.

Padding rules, from the flax module:
  * the 2x2/2 'SAME' pools pad at the end on odd maps (75 -> 38):
    ``MaxPool2d(2, 2, ceil_mode=True)``;
  * pool5 is 3x3/1 'SAME': ``MaxPool2d(3, 1, padding=1)`` (pads with -inf);
  * fc6 is 3x3 dilation 6 'SAME' (padding 6); conv6_2 and conv7_2 pad 1 and
    stride 2; conv8_2 and conv9_2 are 'VALID'.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.devices import target_device
from ssd_keras_torch.models.common import (
    SSDModule,
    apply_mode,
    assemble_predictions,
    init_weights,
    same_pool_size,
    valid_size,
)
from ssd_keras_torch.models.layers import L2Normalization, MaxPool, preprocess_input

__all__ = ["SSD300", "ssd_300", "ssd300_predictor_sizes", "init_weights"]

# (feature source name, its channels) per predictor layer, in order.
_HEAD_SOURCES = (
    ("conv4_3_norm", 512),
    ("fc7", 1024),
    ("conv6_2", 512),
    ("conv7_2", 256),
    ("conv8_2", 256),
    ("conv9_2", 256),
)

# pool1-4, 2x2/2 'SAME' (75 -> 38), and pool5, 3x3/1 'SAME'.
_POOL = MaxPool(2, 2, ceil_mode=True)
_POOL5 = MaxPool(3, 1, 1)

# name -> (in, out, kernel, Conv2d keyword arguments), in graph order.
_CONVS = {
    "conv1_1": (3, 64, 3, dict(padding=1)),
    "conv1_2": (64, 64, 3, dict(padding=1)),
    "conv2_1": (64, 128, 3, dict(padding=1)),
    "conv2_2": (128, 128, 3, dict(padding=1)),
    "conv3_1": (128, 256, 3, dict(padding=1)),
    "conv3_2": (256, 256, 3, dict(padding=1)),
    "conv3_3": (256, 256, 3, dict(padding=1)),
    "conv4_1": (256, 512, 3, dict(padding=1)),
    "conv4_2": (512, 512, 3, dict(padding=1)),
    "conv4_3": (512, 512, 3, dict(padding=1)),
    "conv5_1": (512, 512, 3, dict(padding=1)),
    "conv5_2": (512, 512, 3, dict(padding=1)),
    "conv5_3": (512, 512, 3, dict(padding=1)),
    "fc6": (512, 1024, 3, dict(padding=6, dilation=6)),
    "fc7": (1024, 1024, 1, {}),
    "conv6_1": (1024, 256, 1, {}),
    "conv6_2": (256, 512, 3, dict(stride=2, padding=1)),
    "conv7_1": (512, 128, 1, {}),
    "conv7_2": (128, 256, 3, dict(stride=2, padding=1)),
    "conv8_1": (256, 128, 1, {}),
    "conv8_2": (128, 256, 3, {}),
    "conv9_1": (256, 128, 1, {}),
    "conv9_2": (128, 256, 3, {}),
}


def ssd300_predictor_sizes(img_height: int, img_width: int) -> List[Tuple[int, int]]:
    """Static (fh, fw) of the 6 predictor layers for a given input size."""

    def both(f, h, w, *args):
        return f(h, *args), f(w, *args)

    h, w = both(same_pool_size, img_height, img_width)  # pool1
    h, w = both(same_pool_size, h, w)  # pool2
    h, w = both(same_pool_size, h, w)  # pool3
    conv4_3 = (h, w)
    h, w = both(same_pool_size, h, w)  # pool4; pool5 is stride 1
    fc7 = (h, w)
    h, w = both(valid_size, h, w, 3, 2, 1)  # conv6_2: pad 1, 3x3/s2 valid
    conv6_2 = (h, w)
    h, w = both(valid_size, h, w, 3, 2, 1)  # conv7_2
    conv7_2 = (h, w)
    h, w = both(valid_size, h, w, 3, 1, 0)  # conv8_2: 3x3/s1 valid
    conv8_2 = (h, w)
    h, w = both(valid_size, h, w, 3, 1, 0)  # conv9_2
    conv9_2 = (h, w)
    return [conv4_3, fc7, conv6_2, conv7_2, conv8_2, conv9_2]


class SSD300(SSDModule):
    """The SSD300 network. ``forward`` takes (B, H, W, 3) images and returns
    the mode-dependent output:

    * 'training': ``(batch, 8732, n_classes + 13)`` raw predictions (f32)
    * 'inference' / 'inference_fast': ``(batch, top_k, 6)`` decoded detections

    Parameters are f32; the convolutions run in ``compute_dtype``.
    """

    def __init__(self, config: SSDConfig, mode: str = "training",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(config, mode, compute_dtype,
                         ssd300_predictor_sizes(config.img_height, config.img_width))
        for name, (cin, cout, k, kw) in _CONVS.items():
            self.add_module(name, nn.Conv2d(cin, cout, k, **kw))
        self.conv4_3_norm = L2Normalization(512)
        n_classes = config.n_classes_with_background
        for (src, cin), n_boxes in zip(_HEAD_SOURCES, config.n_boxes_per_cell):
            self.add_module(f"{src}_mbox_conf",
                            nn.Conv2d(cin, n_boxes * n_classes, 3, padding=1))
            self.add_module(f"{src}_mbox_loc", nn.Conv2d(cin, n_boxes * 4, 3, padding=1))

    def _convs(self, x: torch.Tensor, names, pool: Optional[MaxPool] = None) -> torch.Tensor:
        """The named convolutions in turn, each with its ReLU; ``pool`` after
        the last (in its epilogue without autograd)."""
        for k, name in enumerate(names):
            x = self.conv(x, name, relu=True, pool=pool if k == len(names) - 1 else None)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        consts = self._constants(x.device)
        x = preprocess_input(
            x.to(self.compute_dtype), consts["subtract_mean"], consts["divide_by_stddev"],
            consts["swap_channels"],
        ).permute(0, 3, 1, 2)

        x = self._convs(x, ("conv1_1", "conv1_2"), _POOL)
        x = self._convs(x, ("conv2_1", "conv2_2"), _POOL)
        x = self._convs(x, ("conv3_1", "conv3_2", "conv3_3"), _POOL)
        conv4_3 = self._convs(x, ("conv4_1", "conv4_2", "conv4_3"))
        x = _POOL(conv4_3)  # conv4_3 also feeds conv4_3_norm
        x = self._convs(x, ("conv5_1", "conv5_2", "conv5_3"), _POOL5)
        fc7 = self._convs(x, ("fc6", "fc7"))
        conv6_2 = self._convs(fc7, ("conv6_1", "conv6_2"))
        conv7_2 = self._convs(conv6_2, ("conv7_1", "conv7_2"))
        conv8_2 = self._convs(conv7_2, ("conv8_1", "conv8_2"))
        conv9_2 = self._convs(conv8_2, ("conv9_1", "conv9_2"))
        features = dict(
            conv4_3_norm=self.conv4_3_norm(conv4_3),
            fc7=fc7,
            conv6_2=conv6_2,
            conv7_2=conv7_2,
            conv8_2=conv8_2,
            conv9_2=conv9_2,
        )
        conf_maps, loc_maps = [], []
        for src, _ in _HEAD_SOURCES:
            conf_map, loc_map = self.heads(features[src], f"{src}_mbox_conf", f"{src}_mbox_loc")
            conf_maps.append(conf_map)
            loc_maps.append(loc_map)
        predictions = assemble_predictions(
            conf_maps, loc_maps, consts["anchors"], cfg.n_classes_with_background
        )
        return apply_mode(predictions, self.mode, cfg)


def ssd_300(
    config: Optional[SSDConfig] = None,
    mode: str = "training",
    compute_dtype: torch.dtype = torch.float32,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    **config_overrides,
):
    """Build an SSD300 model on ``device`` (the card unless the caller asks
    for the CPU; no card raises). Returns ``(module, predictor_sizes)``.

    Weights are drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``; the global one if None), so one seed gives the same
    weights on every device, then moved; they stay f32, and the forward
    casts them to ``compute_dtype`` at use. With
    no ``config`` the canonical Pascal-VOC configuration is used;
    ``config_overrides`` go to :meth:`SSDConfig.ssd300`.
    """
    device = target_device(device)
    if config is None:
        config = SSDConfig.ssd300(**config_overrides)
    elif config_overrides:
        raise ValueError("Pass either a config or overrides, not both.")
    module = SSD300(config, mode=mode, compute_dtype=compute_dtype)
    init_weights(module, generator)
    module.to(device=device).eval()
    sizes = ssd300_predictor_sizes(config.img_height, config.img_width)
    return module, np.array(sizes)
