"""Shared model building blocks (PyTorch).

Port of ``ssd_keras_tpu/models/layers.py``. Parameter names follow the
reference's Keras layer names (``conv4_3_norm.gamma``, ``{src}_mbox_conf``,
``{src}_mbox_loc``) so that ``weights_io`` maps weights by name.

Images enter the model in the JAX layout (B, H, W, 3); inside, feature maps
are NCHW as PyTorch's convolutions expect.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["L2Normalization", "preprocess_input", "fused_prediction_heads"]


class L2Normalization(nn.Module):
    """Channel-wise L2 normalization with a learnable per-channel scale.

    ParseNet-style, on conv4_3 with gamma initialised to 20 (the reference's
    keras_layer_L2Normalization.py:25-63). Keras' ``K.l2_normalize`` is
    ``x / sqrt(max(sum(x^2), 1e-12))``; the sum runs over channels (dim 1).
    """

    def __init__(self, channels: int, gamma_init: float = 20.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((channels,), float(gamma_init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.clamp_min(torch.sum(x * x, dim=1, keepdim=True), 1e-12))
        return x / norm * self.gamma.to(x.dtype)[None, :, None, None]


def preprocess_input(
    x: torch.Tensor,
    subtract_mean: Optional[Union[Sequence[float], torch.Tensor]],
    divide_by_stddev: Optional[Union[Sequence[float], torch.Tensor]],
    swap_channels: Optional[Union[Sequence[int], torch.Tensor]],
) -> torch.Tensor:
    """In-graph Caffe-style input preprocessing on (B, H, W, C) images.

    Mean subtraction, stddev division, then channel reordering — the same
    pipeline as the reference's Lambda layers (keras_ssd300.py:247-272).
    Each argument may be a tensor already on ``x``'s device: a sequence is
    copied there, which on a CUDA device waits for the device.
    """
    if subtract_mean is not None:
        x = x - torch.as_tensor(subtract_mean, device=x.device).to(x.dtype)
    if divide_by_stddev is not None:
        x = x / torch.as_tensor(divide_by_stddev, device=x.device).to(x.dtype)
    if swap_channels is not None and len(swap_channels):
        x = x.index_select(-1, torch.as_tensor(swap_channels, device=x.device))
    return x


def fused_prediction_heads(
    feat: torch.Tensor, conf: nn.Conv2d, loc: nn.Conv2d
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the 3x3 conf and loc heads of one feature map as a single conv.

    The weights stay in two modules under the reference names; they are
    concatenated along the output channels for one convolution, whose
    per-channel results equal the two separate ones. Returns both maps
    permuted to NHWC, the order the prediction tensor's boxes follow
    (``models/common.py``).
    """
    weight = torch.cat([conf.weight, loc.weight], dim=0)
    bias = torch.cat([conf.bias, loc.bias], dim=0)
    out = F.conv2d(feat, weight, bias, padding=1).permute(0, 2, 3, 1)
    n_conf = conf.out_channels
    return out[..., :n_conf], out[..., n_conf:]
