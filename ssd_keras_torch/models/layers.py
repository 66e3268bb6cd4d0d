"""Shared model building blocks (PyTorch).

Port of ``ssd_keras_tpu/models/layers.py``. Parameter names follow the
reference's Keras layer names (``conv4_3_norm.gamma``, ``{src}_mbox_conf``,
``{src}_mbox_loc``) so that ``weights_io`` maps weights by name.

Images enter the model in the JAX layout (B, H, W, 3); inside, feature maps
are NCHW as PyTorch's convolutions expect.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssd_keras_torch.kernels import conv_epilogue as epilogue_kernel
from ssd_keras_torch.ops.anchors import anchor_grid_for_layer
from ssd_keras_torch.ops.conv_epilogue import MaxPool

__all__ = ["BatchNorm", "batch_statistics_over", "L2Normalization", "AnchorBoxes",
           "preprocess_input", "MaxPool", "conv2d_epilogue", "fuse_head_params",
           "fused_prediction_heads"]

# The process group over whose ranks BatchNorm takes its batch statistics,
# set only inside ``batch_statistics_over``.
_STATS_GROUP: contextvars.ContextVar = contextvars.ContextVar("batch_statistics_group",
                                                              default=None)


@contextlib.contextmanager
def batch_statistics_over(group):
    """Inside the block, every BatchNorm in training mode takes its batch
    statistics over the rows of all ranks of ``group`` (``None``: its own
    rows), as flax's are over the global batch under a mesh. The data-
    parallel train step runs its forward pass in this block; nothing
    outside it sees the group."""
    token = _STATS_GROUP.set(group)
    try:
        yield
    finally:
        _STATS_GROUP.reset(token)


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


class AnchorBoxes(nn.Module):
    """Anchor constants for one predictor layer, for custom models.

    The built-in SSD300/512/7 models take their anchors from
    ``SSDConfig.anchor_tensor``; this module is for users composing their own
    backbones in the style of the reference's ``AnchorBoxes`` Keras layer
    (keras_layers/keras_layer_AnchorBoxes.py:27). Given an NCHW feature map
    ``(B, ch, fh, fw)`` it returns the ``(B, fh, fw, n_boxes, 8)`` float32
    anchors and variances on the feature map's device, the values of the JAX
    package's layer (which takes its map as (B, fh, fw, ch)). They are
    computed once per map size and device.
    """

    def __init__(self, img_height: int, img_width: int, this_scale: float, next_scale: float,
                 aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 two_boxes_for_ar1: bool = True, this_steps: Optional[float] = None,
                 this_offsets: Optional[float] = None, clip_boxes: bool = False,
                 variances: Sequence[float] = (0.1, 0.1, 0.2, 0.2), coords: str = "centroids",
                 normalize_coords: bool = True):
        super().__init__()
        self.img_height, self.img_width = img_height, img_width
        self.this_scale, self.next_scale = this_scale, next_scale
        self.aspect_ratios = tuple(aspect_ratios)
        self.two_boxes_for_ar1 = two_boxes_for_ar1
        self.this_steps, self.this_offsets = this_steps, this_offsets
        self.clip_boxes = clip_boxes
        self.variances = tuple(variances)
        self.coords = coords
        self.normalize_coords = normalize_coords
        self._anchors = {}

    def _constant(self, fh: int, fw: int, device) -> torch.Tensor:
        key = (fh, fw, str(device))
        if key not in self._anchors:
            grid = anchor_grid_for_layer(
                self.img_height, self.img_width, (fh, fw), list(self.aspect_ratios),
                self.this_scale, self.next_scale, two_boxes_for_ar1=self.two_boxes_for_ar1,
                this_steps=self.this_steps, this_offsets=self.this_offsets,
                clip_boxes=self.clip_boxes, normalize_coords=self.normalize_coords,
                coords=self.coords,
            )
            var = np.broadcast_to(np.asarray(self.variances, np.float64), grid.shape)
            self._anchors[key] = torch.from_numpy(
                np.concatenate([grid, var], axis=-1).astype(np.float32)).to(device)
        return self._anchors[key]

    def forward(self, feature_map: torch.Tensor) -> torch.Tensor:
        anchors = self._constant(feature_map.shape[2], feature_map.shape[3], feature_map.device)
        return anchors[None].expand((feature_map.shape[0],) + anchors.shape)


class BatchNorm(nn.Module):
    """Batch normalisation over the channels of NCHW maps, as flax computes it.

    ``flax.linen.BatchNorm`` (the JAX SSD7's ``bn{i}``, with Keras' momentum
    0.99 and epsilon 1e-3) differs from ``nn.BatchNorm2d`` in ways a parity
    test sees:

    * the batch variance is ``max(0, E[x^2] - E[x]^2)``, and the running
      variance takes that *biased* value (``BatchNorm2d`` takes the unbiased
      one);
    * the running statistics move as ``momentum * ra + (1 - momentum) * stat``
      (``BatchNorm2d``'s momentum is ``1 - momentum``);
    * statistics and normalisation run in f32 under any compute dtype; the
      output takes the input's dtype.

    Parameters ``weight`` (flax ``scale``) and ``bias``; buffers
    ``running_mean`` and ``running_var`` (flax ``batch_stats`` ``mean`` and
    ``var``). ``self.training`` selects batch or running statistics.

    Inside :func:`batch_statistics_over` a group (the data-parallel train
    step's forward pass), the batch statistics are the global batch's: a
    differentiable all-reduce of the per-channel sums of x and x^2 in f32,
    so the gradient through the statistics is the global one, and the
    running statistics stay equal on every rank. Every rank holds as many
    rows.
    """

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-3):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def _batch_moments(self, xf: torch.Tensor):
        """E[x] and E[x^2] per channel, over the (global) batch: the sums
        over the rows (and ranks) over the count, the same operations with
        and without a group."""
        sums = torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])
        count = xf.numel() // xf.shape[1]
        group = _STATS_GROUP.get()
        if group is not None:
            # Imported here: torch.distributed.nn is slow to import, and only
            # a data-parallel step needs it. Its backward all-reduces the
            # gradient, as each rank's loss depends on the global sums.
            from torch.distributed.nn.functional import all_reduce

            sums = all_reduce(sums, group=group)
            count *= torch.distributed.get_world_size(group)
        return sums[0] / count, sums[1] / count

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean, mean2 = self._batch_moments(xf)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


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


def conv2d_epilogue(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    stride: Union[int, Tuple[int, int]] = 1, padding: Union[int, Tuple[int, int]] = 0,
    dilation: Union[int, Tuple[int, int]] = 1, relu: bool = False,
    residual: Optional[torch.Tensor] = None, pool: Optional[MaxPool] = None,
) -> torch.Tensor:
    """``pool?(relu?(conv2d(x, weight, bias) + residual?))``: the one place
    the models run a convolution with a bias; ``pool`` is for a convolution
    that feeds only a max pool after its ReLU, and takes no residual and,
    without autograd, a channels_last ``x`` (as the models' maps are).

    While autograd records (training), PyTorch's own ops: the convolution
    with its bias, then the residual's add, then the ReLU, then the pool.
    While it does not (``no_grad``, ``inference_mode``: serving,
    evaluation), the convolution without its bias, then one pass of the
    epilogue kernel over its output (``kernels/conv_epilogue.py``; its
    plain version on the CPU), which rounds as those ops round: in place,
    or with ``pool`` the pooled variant, which writes only the pooled map.
    The kernels have no backward.
    """
    if pool is not None and (residual is not None or not relu):
        raise ValueError("a pooled convolution takes the ReLU and no residual")
    if torch.is_grad_enabled():
        y = F.conv2d(x, weight, bias, stride, padding, dilation)
        if residual is not None:
            y = y + residual
        y = F.relu(y) if relu else y
        return y if pool is None else pool(y)
    y = F.conv2d(x, weight, None, stride, padding, dilation)
    if pool is not None:
        return epilogue_kernel.conv_epilogue_pool(y, bias, pool)
    return epilogue_kernel.conv_epilogue(y, bias, residual, relu)


def fuse_head_params(conf_weight: torch.Tensor, loc_weight: torch.Tensor,
                     conf_bias: torch.Tensor, loc_bias: torch.Tensor,
                     dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The conf and loc heads' weights and biases concatenated along the
    output channels (conf first) and cast to ``dtype``. The weights stay in
    two modules under the reference names."""
    return (torch.cat([conf_weight, loc_weight], dim=0).to(dtype),
            torch.cat([conf_bias, loc_bias], dim=0).to(dtype))


def fused_prediction_heads(
    feat: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, n_conf: int,
    stride: Union[int, Tuple[int, int]] = 1, padding: Union[int, Tuple[int, int]] = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the conf and loc heads of one feature map as a single conv.

    ``weight`` and ``bias`` come from :func:`fuse_head_params`; the
    convolution's per-channel results equal the two separate ones. The
    heads share ``stride`` and ``padding``: 1 and 1 for the VGG SSDs'
    3x3 heads, 3 and 1 for SSD-ResNet34's, whose anchors tile the strided
    grid. Returns the first ``n_conf`` channels (conf) and the rest (loc),
    both permuted to NHWC, the order the prediction tensor's boxes follow
    (``models/common.py``).
    """
    out = conv2d_epilogue(feat, weight, bias, stride, padding).permute(0, 2, 3, 1)
    return out[..., :n_conf], out[..., n_conf:]
