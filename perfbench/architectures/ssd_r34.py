"""SSD-ResNet34, MLPerf Inference's large detector (mlcommons/inference
``vision/classification_and_detection/python/models/ssd_r34.py``: ``SSD_R34``
with ``strides=[3, 3, 2, 2, 2, 2]``), in plain PyTorch.

The trunk is torchvision's ResNet-34 through ``layer3``, whose first block
and downsample take stride 1 (MLPerf's ``_ModifyBlock``): conv1 7x7/2 pad
3, BatchNorm, ReLU, max pool 3x3/2 pad 1; ``layer1`` three BasicBlocks of
64, ``layer2`` four of 128 (the first at stride 2 with a 1x1/2 downsample),
``layer3`` six of 256 (a 1x1/1 downsample); convolutions without bias, each
followed by a BatchNorm in eval mode, (x - mean) / sqrt(var + 1e-5) *
weight + bias, computed unfolded. Then five extra blocks (1x1 conv, ReLU,
3x3 conv, ReLU, with biases) and on each of the six sources a 3x3 class
head and box head at stride 3, padding 1. Input is (B, H, W, 3) RGB in
0-255, less the configuration's ``subtract_mean``, over its
``divide_by_stddev``, channels reordered by ``swap_channels`` if given.
Class scores are the softmax over the classes, background first; each
head's channels are read as ssd_keras reads them, (rows, columns, boxes).

``sources`` names each predictor layer by its class head: a head's grid,
which its anchors tile (``feature_sizes`` of that name), is the strided
head's output, a third of its source's size.

The weights' rules: He-normal kernels, zero biases; every BatchNorm weight
1, bias 0.1, running mean 0.1, running variance 2 (not the identity, so
that folding them into the convolutions shows its arithmetic); the class
heads scaled by 1/8 and the box heads by 1/16. The trunk's residual
stream leaves the sources at an RMS of ~5-8, which unscaled heads carry
into saturated softmaxes and offsets; scaled, 3% of the class scores of
the serving cell's photos at 1200x1200 clear the decode's 0.05 (85% of
the boxes have one, and every image fills its 200 detections, as a
trained detector's do at that threshold), and offsets sit at ~0.34 RMS
(at 400x400), near their anchors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.ssd import _quantize, boxes_per_cell, conv_out

PORT_BUILDER = "ssd_keras_torch.models.ssd_r34:ssd_r34_mlperf"
BN_EPS = 1e-5
BN_CONSTANTS = {"weight": 1.0, "bias": 0.1, "running_mean": 0.1, "running_var": 2.0}
CONF_SCALE = 0.125
LOC_SCALE = 0.0625
HEAD_STRIDE = 3

# (name, in, out, kernel, stride, padding, BatchNorm or None), in graph order.
Conv = Tuple[str, int, int, int, int, int, Optional[str]]


def _trunk() -> List[Conv]:
    table = [("conv1", 3, 64, 7, 2, 3, "bn1")]
    cin = 64
    for i, (blocks, ch, stride) in enumerate(((3, 64, 1), (4, 128, 2), (6, 256, 1)), start=1):
        for j in range(blocks):
            p, s = f"layer{i}.{j}", stride if j == 0 else 1
            table += [(f"{p}.conv1", cin, ch, 3, s, 1, f"{p}.bn1"),
                      (f"{p}.conv2", ch, ch, 3, 1, 1, f"{p}.bn2")]
            if j == 0 and (s != 1 or cin != ch):
                table.append((f"{p}.downsample.0", cin, ch, 1, s, 0, f"{p}.downsample.1"))
            cin = ch
    return table


TRUNK = _trunk()
# (in, mid, out, stride, padding of the 3x3) of the extra blocks.
EXTRAS = [(256, 256, 512, 2, 1), (512, 256, 512, 2, 1), (512, 128, 256, 2, 1),
          (256, 128, 256, 2, 0), (256, 128, 256, 1, 0)]
SOURCE_CHANNELS = [256] + [out for _, _, out, _, _ in EXTRAS]


def _extras() -> List[Conv]:
    table = []
    for i, (cin, mid, out, s, p) in enumerate(EXTRAS):
        table += [(f"additional_blocks.{i}.0", cin, mid, 1, 1, 0, None),
                  (f"additional_blocks.{i}.2", mid, out, 3, s, p, None)]
    return table


def _heads(config: dict) -> List[Conv]:
    classes = config["n_classes"] + 1
    table = []
    for i, (ch, n) in enumerate(zip(SOURCE_CHANNELS, boxes_per_cell(config))):
        table += [(f"conf{i}", ch, n * classes, 3, HEAD_STRIDE, 1, None),
                  (f"loc{i}", ch, n * 4, 3, HEAD_STRIDE, 1, None)]
    return table


def _table(config: dict) -> List[Conv]:
    return TRUNK + _extras() + _heads(config)


def conv_table(config: dict):
    return [(name, cin, cout, k, s, p, 1) for name, cin, cout, k, s, p, _ in _table(config)]


def feature_sizes(config: dict) -> Dict[str, Tuple[int, int]]:
    def out(hw, k, s, p):
        return tuple(conv_out(v, k, s, p, 1) for v in hw)

    sizes = {"conv1": out((config["img_height"], config["img_width"]), 7, 2, 3)}
    hw = sizes["maxpool"] = out(sizes["conv1"], 3, 2, 1)
    for name, _, _, k, s, p, _ in TRUNK[1:]:
        if name.endswith(".conv1"):
            block_in = hw
        # conv2 reads conv1's output; conv1 and the downsample the block's input.
        sizes[name] = out(hw if name.endswith(".conv2") else block_in, k, s, p)
        if not name.endswith(".downsample.0"):
            hw = sizes[name]
    src = [hw]
    for name, _, _, k, s, p, _ in _extras():
        hw = sizes[name] = out(hw, k, s, p)
        if name.endswith(".2"):
            src.append(hw)
    for i, hw in enumerate(src):
        sizes[f"source{i}"] = hw
        sizes[f"conf{i}"] = sizes[f"loc{i}"] = out(hw, 3, HEAD_STRIDE, 1)
    return sizes


def sources(config: dict) -> List[Tuple[str, int]]:
    return [(f"conf{i}", ch) for i, ch in enumerate(SOURCE_CHANNELS)]


def parameters(config: dict) -> dict:
    params = {}
    for name, cin, cout, k, _, _, bn in _table(config):
        scale = CONF_SCALE if name.startswith("conf") else (
            LOC_SCALE if name.startswith("loc") else 1.0)
        params[f"{name}.weight"] = ((cout, cin, k, k), ("he_normal", scale))
        if bn is None:
            params[f"{name}.bias"] = ((cout,), ("constant", 0.0))
        else:
            params.update({f"{bn}.{key}": ((cout,), ("constant", value))
                           for key, value in BN_CONSTANTS.items()})
    return params


def forward(config: dict, params: Dict[str, torch.Tensor], images: torch.Tensor,
            quantize: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = images.device
    x = images.float() - torch.tensor(config["subtract_mean"], device=dev)
    x = x / torch.tensor(config["divide_by_stddev"], device=dev)
    if config.get("swap_channels"):
        x = x[..., list(config["swap_channels"])]
    x = x.permute(0, 3, 1, 2)

    def conv(t, name, stride, pad):
        w = params[f"{name}.weight"].float()
        b = params.get(f"{name}.bias")
        return F.conv2d(_quantize(t, quantize), _quantize(w, quantize),
                        None if b is None else b.float(), stride, pad)

    def conv_bn(t, name, stride, pad, bn):
        y = conv(t, name, stride, pad)
        mean, var = params[f"{bn}.running_mean"].float(), params[f"{bn}.running_var"].float()
        weight, bias = params[f"{bn}.weight"].float(), params[f"{bn}.bias"].float()
        y = (y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + BN_EPS)
        return y * weight[:, None, None] + bias[:, None, None]

    by_name = {row[0]: row for row in TRUNK}
    x = F.relu(conv_bn(x, "conv1", 2, 3, "bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for name, _, _, _, s, p, bn in TRUNK[1:]:
        if not name.endswith(".conv1"):
            continue
        block = name[:-len(".conv1")]
        y = F.relu(conv_bn(x, name, s, p, bn))
        _, _, _, _, s2, p2, bn2 = by_name[f"{block}.conv2"]
        y = conv_bn(y, f"{block}.conv2", s2, p2, bn2)
        down = by_name.get(f"{block}.downsample.0")
        if down is not None:
            x = conv_bn(x, down[0], down[4], down[5], down[6])
        x = F.relu(y + x)
    feats = [x]
    for i, (_, _, _, s, p) in enumerate(EXTRAS):
        x = F.relu(conv(x, f"additional_blocks.{i}.0", 1, 0))
        x = F.relu(conv(x, f"additional_blocks.{i}.2", s, p))
        feats.append(x)
    classes = config["n_classes"] + 1
    b = images.shape[0]
    confs, locs = [], []
    for i, f in enumerate(feats):
        conf = conv(f, f"conf{i}", HEAD_STRIDE, 1)
        confs.append(conf.permute(0, 2, 3, 1).reshape(b, -1, classes))
        loc = conv(f, f"loc{i}", HEAD_STRIDE, 1)
        locs.append(loc.permute(0, 2, 3, 1).reshape(b, -1, 4))
    return torch.softmax(torch.cat(confs, 1), -1), torch.cat(locs, 1)
