"""SSD512: VGG-16 backbone + 5 extra stages + 7 multibox heads (PyTorch).

Port of ``ssd_keras_tpu/models/ssd512.py``: the SSD300 topology with conv8_2
and conv9_2 at stride 2 and a final conv10 stage, giving 7 predictor layers
and 24564 anchors at 512x512, with the reference's layer names (so
``weights_io`` maps flax and Keras weights by name) and the same prediction
tensor layout. Images come in as (B, H, W, 3), as in the JAX package.

Padding rules, from the flax module (SSD300's, apart from the extras):
  * the 2x2/2 'SAME' pools pad at the end on odd maps:
    ``MaxPool2d(2, 2, ceil_mode=True)``; pool5 is 3x3/1 'SAME';
  * conv6_2 .. conv9_2 pad 1 and stride 2 (SSD300's conv8_2 and conv9_2 are
    'VALID' at stride 1);
  * conv10_2 is 4x4 'VALID' after a pad of 1 (at 512x512 it maps 2x2 to 1x1).
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
from ssd_keras_torch.models.ssd300 import _CONVS as _SSD300_CONVS
from ssd_keras_torch.models.ssd300 import _POOL, _POOL5

__all__ = ["SSD512", "ssd_512", "ssd512_predictor_sizes"]

# (feature source name, its channels) per predictor layer, in order.
_HEAD_SOURCES = (
    ("conv4_3_norm", 512),
    ("fc7", 1024),
    ("conv6_2", 512),
    ("conv7_2", 256),
    ("conv8_2", 256),
    ("conv9_2", 256),
    ("conv10_2", 256),
)

# name -> (in, out, kernel, Conv2d keyword arguments), in graph order: SSD300's
# trunk and first extras, then the stride-2 conv8_2/conv9_2 and conv10.
_CONVS = {
    **_SSD300_CONVS,
    "conv8_2": (128, 256, 3, dict(stride=2, padding=1)),
    "conv9_2": (128, 256, 3, dict(stride=2, padding=1)),
    "conv10_1": (256, 128, 1, {}),
    "conv10_2": (128, 256, 4, dict(padding=1)),
}


def ssd512_predictor_sizes(img_height: int, img_width: int) -> List[Tuple[int, int]]:
    """Static (fh, fw) of the 7 predictor layers for a given input size."""

    def both(f, h, w, *args):
        return f(h, *args), f(w, *args)

    h, w = both(same_pool_size, img_height, img_width)  # pool1
    h, w = both(same_pool_size, h, w)  # pool2
    h, w = both(same_pool_size, h, w)  # pool3
    conv4_3 = (h, w)
    h, w = both(same_pool_size, h, w)  # pool4; pool5 is stride 1
    fc7 = (h, w)
    h, w = both(valid_size, h, w, 3, 2, 1)
    conv6_2 = (h, w)
    h, w = both(valid_size, h, w, 3, 2, 1)
    conv7_2 = (h, w)
    h, w = both(valid_size, h, w, 3, 2, 1)  # conv8_2 is stride 2 in SSD512
    conv8_2 = (h, w)
    h, w = both(valid_size, h, w, 3, 2, 1)  # conv9_2 stride 2
    conv9_2 = (h, w)
    h, w = both(valid_size, h, w, 4, 1, 1)  # conv10_2: pad 1, 4x4 VALID
    conv10_2 = (h, w)
    return [conv4_3, fc7, conv6_2, conv7_2, conv8_2, conv9_2, conv10_2]


class SSD512(SSDModule):
    """The SSD512 network. ``forward`` takes (B, H, W, 3) images and returns
    the mode-dependent output:

    * 'training': ``(batch, 24564, n_classes + 13)`` raw predictions (f32)
    * 'inference' / 'inference_fast': ``(batch, top_k, 6)`` decoded detections

    Parameters are f32; the convolutions run in ``compute_dtype``.
    """

    def __init__(self, config: SSDConfig, mode: str = "training",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(config, mode, compute_dtype,
                         ssd512_predictor_sizes(config.img_height, config.img_width))
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
        conv10_2 = self._convs(conv9_2, ("conv10_1", "conv10_2"))
        features = dict(
            conv4_3_norm=self.conv4_3_norm(conv4_3),
            fc7=fc7,
            conv6_2=conv6_2,
            conv7_2=conv7_2,
            conv8_2=conv8_2,
            conv9_2=conv9_2,
            conv10_2=conv10_2,
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


def ssd_512(
    config: Optional[SSDConfig] = None,
    mode: str = "training",
    compute_dtype: torch.dtype = torch.float32,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    **config_overrides,
):
    """Build an SSD512 model on ``device`` (the card unless the caller asks
    for the CPU; no card raises). Returns ``(module, predictor_sizes)``.

    Weights are drawn on the CPU from ``generator`` as in ``ssd_300`` and
    stay f32. With no ``config`` the canonical Pascal-VOC configuration is
    used; ``config_overrides`` go to :meth:`SSDConfig.ssd512`.
    """
    device = target_device(device)
    if config is None:
        config = SSDConfig.ssd512(**config_overrides)
    elif config_overrides:
        raise ValueError("Pass either a config or overrides, not both.")
    module = SSD512(config, mode=mode, compute_dtype=compute_dtype)
    init_weights(module, generator)
    module.to(device=device).eval()
    sizes = ssd512_predictor_sizes(config.img_height, config.img_width)
    return module, np.array(sizes)
