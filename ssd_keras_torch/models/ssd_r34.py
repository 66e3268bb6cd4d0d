"""SSD-ResNet34 at 1200x1200: MLPerf Inference's large detector (PyTorch).

The network of mlcommons/inference ``vision/classification_and_detection/
python/models/ssd_r34.py`` (``SSD_R34`` with ``strides=[3, 3, 2, 2, 2, 2]``):

* the trunk is torchvision's ResNet-34 through ``layer3``: conv1 7x7/2 with
  BatchNorm and ReLU, a 3x3/2 max pool, ``layer1`` (3 BasicBlocks of 64),
  ``layer2`` (4 of 128, the first at stride 2 with a 1x1/2 downsample) and
  ``layer3`` (6 of 256, its first block and downsample at stride 1); the
  convolutions have no bias and each is followed by a BatchNorm (29 in all,
  epsilon 1e-5);
* five extra blocks, each a 1x1 conv and a 3x3 conv with biases and ReLUs
  (3x3 at stride 2 with padding 1, 2 / 1, 2 / 1, 2 / 0 and 1 / 0);
* a conf and a loc head, 3x3 with padding 1 at **stride 3**, on each of the
  six sources (``layer3`` and the five extras): at 1200x1200 the sources
  are 150, 75, 38, 19, 9 and 7 wide and the heads' grids, which the anchors
  tile, 50, 25, 13, 7, 3 and 3: 15,130 anchors.

Parameter names follow torchvision's (``conv1.weight``, ``bn1.running_var``,
``layer3.0.downsample.0.weight``, ...), MLPerf's for the extras
(``additional_blocks.{i}.0`` and ``.2``), and ``conf{i}`` / ``loc{i}`` for
the heads. Anchors and the prediction tensor follow ssd_keras: each head's
channels are read as (rows, columns, boxes), where MLPerf's
``view(B, 4, -1)`` reads (boxes, rows, columns); and anchors are not
clipped. Images come in as (B, H, W, 3) RGB in 0-255.

The module keeps the BatchNorms' four tensors, so a torchvision-named
state dict, less its ``num_batches_tracked``, loads as it is. It serves with every BatchNorm folded into its
convolution (``optimize.fold_batchnorm`` at epsilon 1e-5): the first
forward without autograd folds all 29 (span ``model.fold_bn``, counter
``model.bn_folded``), and a forward after any of their tensors changed
(``load_state_dict``, ``.to()``) folds again. With ``fold_bn=False`` the
BatchNorms run as layers instead. It is an inference network: the modes
are 'inference' and 'inference_fast'.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

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
    valid_size,
)
from ssd_keras_torch.models.layers import BatchNorm, MaxPool, conv2d_epilogue, preprocess_input
from ssd_keras_torch.optimize import fold_batchnorm
from ssd_keras_torch.utils.profiling import count, span

__all__ = ["SSDR34", "ssd_r34", "ssd_r34_mlperf", "ssd_r34_predictor_sizes",
           "MLPERF_MEAN", "MLPERF_STD"]

# torchvision's BatchNorm2d epsilon.
BN_EPS = 1e-5
# MLPerf's preprocessing: RGB, ImageNet's mean and standard deviation on 0-255.
MLPERF_MEAN = (123.675, 116.28, 103.53)
MLPERF_STD = (58.395, 57.12, 57.375)
# (blocks, channels, stride of the first block) of layer1..layer3.
_LAYERS = ((3, 64, 1), (4, 128, 2), (6, 256, 1))
# The extra blocks: (in, mid, out, stride, padding of the 3x3 conv).
_EXTRAS = ((256, 256, 512, 2, 1), (512, 256, 512, 2, 1), (512, 128, 256, 2, 1),
           (256, 128, 256, 2, 0), (256, 128, 256, 1, 0))
# Channels of the six sources: layer3, then each extra block.
_SOURCE_CHANNELS = (256,) + tuple(out for _, _, out, _, _ in _EXTRAS)
HEAD_STRIDE = 3


def ssd_r34_predictor_sizes(img_height: int, img_width: int) -> List[Tuple[int, int]]:
    """Static (fh, fw) of the six heads' grids for a given input size."""

    def both(h, w, *args):
        return valid_size(h, *args), valid_size(w, *args)

    h, w = both(img_height, img_width, 7, 2, 3)  # conv1
    h, w = both(h, w, 3, 2, 1)  # max pool
    h, w = both(h, w, 3, 2, 1)  # layer2; layer1 and layer3 keep the size
    sources = [(h, w)]
    for _, _, _, stride, pad in _EXTRAS:
        h, w = both(h, w, 3, stride, pad)
        sources.append((h, w))
    sizes = [both(h, w, 3, HEAD_STRIDE, 1) for h, w in sources]
    if min(min(s) for s in sizes) < 1:
        raise ValueError(f"Input {img_height}x{img_width} is too small for SSD-ResNet34's "
                         "extra layers; both sides must be at least 385.")
    return sizes


class _BasicBlock(nn.Module):
    """torchvision's BasicBlock as parameters: ``conv1``/``bn1``,
    ``conv2``/``bn2`` and an optional ``downsample`` (1x1 conv, BatchNorm);
    ``SSDR34.forward`` runs it."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(cout, eps=BN_EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(cout, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            BatchNorm(cout, eps=BN_EPS))


class SSDR34(SSDModule):
    """The SSD-ResNet34 network. ``forward`` takes (B, H, W, 3) images and
    returns ``(batch, top_k, 6)`` decoded detections (``predictions``, the
    tensor it decodes). Parameters and the
    BatchNorms' statistics are f32; the convolutions run in
    ``compute_dtype``."""

    def __init__(self, config: SSDConfig, mode: str = "inference",
                 compute_dtype: torch.dtype = torch.float32, fold_bn: bool = True):
        if mode == "training":
            raise ValueError("SSD-ResNet34 is built for 'inference' and 'inference_fast' only: "
                             "training it waits for BatchNorm training in the benchmark's "
                             "reference train step.")
        super().__init__(config, mode, compute_dtype,
                         ssd_r34_predictor_sizes(config.img_height, config.img_width))
        self.fold_bn = fold_bn
        self.conv1 = nn.Conv2d(config.img_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64, eps=BN_EPS)
        cin = 64
        for i, (blocks, ch, stride) in enumerate(_LAYERS, start=1):
            layer = [_BasicBlock(cin, ch, stride)]
            layer += [_BasicBlock(ch, ch, 1) for _ in range(blocks - 1)]
            self.add_module(f"layer{i}", nn.Sequential(*layer))
            cin = ch
        self.additional_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(cin, mid, 1), nn.ReLU(inplace=True),
                          nn.Conv2d(mid, out, 3, stride, pad), nn.ReLU(inplace=True))
            for cin, mid, out, stride, pad in _EXTRAS)
        n_classes = config.n_classes_with_background
        for i, (ch, n_boxes) in enumerate(zip(_SOURCE_CHANNELS, config.n_boxes_per_cell)):
            self.add_module(f"conf{i}", nn.Conv2d(ch, n_boxes * n_classes, 3, HEAD_STRIDE, 1))
            self.add_module(f"loc{i}", nn.Conv2d(ch, n_boxes * 4, 3, HEAD_STRIDE, 1))
        # (conv, BatchNorm) by module name, in graph order.
        self.bn_pairs = [("conv1", "bn1")]
        for i, (blocks, _, _) in enumerate(_LAYERS, start=1):
            for j in range(blocks):
                p = f"layer{i}.{j}"
                self.bn_pairs += [(f"{p}.conv1", f"{p}.bn1"), (f"{p}.conv2", f"{p}.bn2")]
                if self.get_submodule(p).downsample is not None:
                    self.bn_pairs.append((f"{p}.downsample.0", f"{p}.downsample.1"))
        super().train(False)

    def train(self, mode: bool = True):
        if mode:
            raise ValueError("SSD-ResNet34 is an inference-only graph.")
        return super().train(mode)

    def _folded(self, dtype: torch.dtype) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Each trunk conv's weight and bias with its BatchNorm folded in,
        in ``dtype``: made once and kept until a conv's or BatchNorm's
        tensor changes (``cast_params``)."""
        state = {}
        for conv, bn in self.bn_pairs:
            state[f"{conv}.weight"] = self.get_submodule(conv).weight
            m = self.get_submodule(bn)
            for key in ("weight", "bias", "running_mean", "running_var"):
                state[f"{bn}.{key}"] = getattr(m, key)
        names = list(state)

        def build(*tensors):
            with span("model.fold_bn"):
                folded = fold_batchnorm(dict(zip(names, tensors)), self.bn_pairs, BN_EPS)
            count("model.bn_folded", len(self.bn_pairs))
            return tuple(folded[f"{conv}.{key}"].to(dtype) for conv, _ in self.bn_pairs
                         for key in ("weight", "bias"))

        flat = self.cast_params(("model.fold_bn", dtype), [state[n] for n in names], build)
        return {conv: flat[2 * i:2 * i + 2] for i, (conv, _) in enumerate(self.bn_pairs)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mode(self.predictions(x), self.mode, self.config)

    def predictions(self, x: torch.Tensor) -> torch.Tensor:
        """The raw ``(batch, boxes, n_classes + 13)`` prediction tensor
        (``models/common.py``; 15,130 boxes at 1200x1200) before the
        decode."""
        consts = self._constants(x.device)
        x = preprocess_input(
            x.float(), consts["subtract_mean"], consts["divide_by_stddev"],
            consts["swap_channels"],
        ).to(self.compute_dtype).permute(0, 3, 1, 2)
        folded = self._folded(x.dtype) if self.fold_bn else None

        def conv_bn(t, conv, bn, relu=False, residual=None, pool=None):
            """The conv and its BatchNorm, then ``residual`` added, the ReLU
            and the max pool, if asked: folded, one ``conv2d_epilogue``."""
            m = self.get_submodule(conv)
            if folded is not None:
                weight, bias = folded[conv]
                return conv2d_epilogue(t, weight, bias, m.stride, m.padding, relu=relu,
                                       residual=residual, pool=pool)
            weight = self.cast_params((conv, t.dtype), (m.weight,), lambda w: (w.to(t.dtype),))[0]
            y = self.get_submodule(bn)(F.conv2d(t, weight, None, m.stride, m.padding))
            if residual is not None:
                y = y.add_(residual)
            y = F.relu_(y) if relu else y
            return y if pool is None else pool(y)

        x = conv_bn(x, "conv1", "bn1", relu=True, pool=MaxPool(3, 2, 1))
        for i, (blocks, _, _) in enumerate(_LAYERS, start=1):
            for j in range(blocks):
                p = f"layer{i}.{j}"
                y = conv_bn(x, f"{p}.conv1", f"{p}.bn1", relu=True)
                # The downsample first, so that conv2's epilogue takes the
                # identity as its residual.
                if self.get_submodule(p).downsample is not None:
                    x = conv_bn(x, f"{p}.downsample.0", f"{p}.downsample.1")
                x = conv_bn(y, f"{p}.conv2", f"{p}.bn2", relu=True, residual=x)
        sources = [x]
        for i in range(len(_EXTRAS)):
            x = self.conv(x, f"additional_blocks.{i}.0", relu=True)
            x = self.conv(x, f"additional_blocks.{i}.2", relu=True)
            sources.append(x)
        conf_maps, loc_maps = [], []
        for i, feat in enumerate(sources):
            conf_map, loc_map = self.heads(feat, f"conf{i}", f"loc{i}")
            conf_maps.append(conf_map)
            loc_maps.append(loc_map)
        return assemble_predictions(conf_maps, loc_maps, consts["anchors"],
                                    self.config.n_classes_with_background)


def ssd_r34_config(**overrides) -> SSDConfig:
    """MLPerf's SSD-ResNet34 on COCO (``dboxes_R34_coco``): 1200x1200, 80
    classes, steps 24 to 400, scales 84 to 1260 pixels over 1200, ratios
    [2] or [2, 3] besides the two ratio-1 boxes, variances 0.1 and 0.2,
    MLPerf's mean and standard deviation, and its decode (score 0.05, NMS
    IoU 0.5, 200 candidates a class, 200 detections)."""
    r2, r3 = (1.0, 2.0, 0.5), (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)
    kw = dict(
        img_height=1200, img_width=1200, img_channels=3, n_classes=80,
        scales=(0.07, 0.15, 0.33, 0.51, 0.69, 0.87, 1.05),
        aspect_ratios=(r2, r3, r3, r3, r2, r2),
        steps=(24, 48, 92, 171, 400, 400), offsets=(0.5,) * 6,
        variances=(0.1, 0.1, 0.2, 0.2),
        subtract_mean=MLPERF_MEAN, divide_by_stddev=MLPERF_STD, swap_channels=None,
        confidence_thresh=0.05, iou_threshold=0.5, top_k=200, nms_max_output_size=200,
    )
    kw.update(overrides)
    return SSDConfig(**kw)


def ssd_r34(
    config: Optional[SSDConfig] = None,
    mode: str = "inference",
    compute_dtype: torch.dtype = torch.float32,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    fold_bn: bool = True,
    **config_overrides,
):
    """Build an SSD-ResNet34 model on ``device`` (the card unless the caller
    asks for the CPU; no card raises). Returns ``(module, predictor_sizes)``.

    Weights are drawn on the CPU from ``generator`` as in ``ssd_300`` (He
    kernels, zero biases; each BatchNorm the identity) and stay f32. With
    no ``config`` MLPerf's configuration is used (``ssd_r34_config``, which
    takes ``config_overrides``).
    """
    device = target_device(device)
    if config is None:
        config = ssd_r34_config(**config_overrides)
    elif config_overrides:
        raise ValueError("Pass either a config or overrides, not both.")
    module = SSDR34(config, mode=mode, compute_dtype=compute_dtype, fold_bn=fold_bn)
    init_weights(module, generator)
    module.to(device=device).eval()
    sizes = ssd_r34_predictor_sizes(config.img_height, config.img_width)
    return module, np.array(sizes)


def ssd_r34_mlperf(config: SSDConfig, mode: str = "inference",
                   compute_dtype: torch.dtype = torch.float32, device="cuda", **kwargs):
    """:func:`ssd_r34` on ``config`` with MLPerf's preprocessing set: its
    mean and standard deviation on RGB, no channel swap."""
    config = dataclasses.replace(config, subtract_mean=MLPERF_MEAN,
                                 divide_by_stddev=MLPERF_STD, swap_channels=None)
    return ssd_r34(config, mode=mode, compute_dtype=compute_dtype, device=device, **kwargs)
