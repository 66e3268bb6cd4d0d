"""VGG-16 under the SSD heads, as SSD300 and SSD512 share it (Liu et al.,
arXiv:1512.02325), in plain PyTorch.

The layer tables and the forward pass follow the paper's Caffe models as
ssd_keras builds them (``keras_ssd300.py``, ``keras_ssd512.py``): VGG-16 to
conv5_3 with 2x2 max pools that pad at the end on odd maps, pool5 3x3
stride 1, fc6 3x3 dilation 6, fc7 1x1, the extra layers, conv4_3
L2-normalised with a learned per-channel scale (ParseNet), and one 3x3
class head and one 3x3 box head a predictor layer. Input is (B, H, W, 3)
RGB in 0-255; the Caffe preprocessing subtracts the mean and swaps to BGR.
Class scores are the softmax over the classes, background first.

The weights' rules: He-normal kernels, zero biases, the L2 norm's scale at
20; conv1_1 scaled by 1/100 (raw He init carries the 0-255 input's
magnitude through the trunk and saturates the softmax) and the box heads
by 1/4 (encoded offsets of ~0.4 RMS keep each box near its anchor), so
that the outputs sit in a trained detector's range: the arithmetic of the
port's ``examples/common.py:scale_to_trained_range``, frozen here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.ssd import _quantize, boxes_per_cell, conv_out

Conv = Tuple[str, int, int, int, int, int, int]

# (name, in, out, kernel, stride, padding, dilation), in graph order.
TRUNK: List[Conv] = [
    ("conv1_1", 3, 64, 3, 1, 1, 1), ("conv1_2", 64, 64, 3, 1, 1, 1),
    ("conv2_1", 64, 128, 3, 1, 1, 1), ("conv2_2", 128, 128, 3, 1, 1, 1),
    ("conv3_1", 128, 256, 3, 1, 1, 1), ("conv3_2", 256, 256, 3, 1, 1, 1),
    ("conv3_3", 256, 256, 3, 1, 1, 1),
    ("conv4_1", 256, 512, 3, 1, 1, 1), ("conv4_2", 512, 512, 3, 1, 1, 1),
    ("conv4_3", 512, 512, 3, 1, 1, 1),
    ("conv5_1", 512, 512, 3, 1, 1, 1), ("conv5_2", 512, 512, 3, 1, 1, 1),
    ("conv5_3", 512, 512, 3, 1, 1, 1),
    ("fc6", 512, 1024, 3, 1, 6, 6), ("fc7", 1024, 1024, 1, 1, 0, 1),
    ("conv6_1", 1024, 256, 1, 1, 0, 1), ("conv6_2", 256, 512, 3, 2, 1, 1),
    ("conv7_1", 512, 128, 1, 1, 0, 1), ("conv7_2", 128, 256, 3, 2, 1, 1),
]
# The layers after which a 2x2/2 pool follows ("pool4" feeds conv5_1).
POOL_AFTER = {"conv1_2", "conv2_2", "conv3_3", "conv4_3"}
L2_GAMMA = 20.0


def conv_table(config: dict, extras: List[Conv],
               sources: List[Tuple[str, int]]) -> List[Conv]:
    """The trunk, ``extras`` and a class and a box head on each source."""
    table = TRUNK + list(extras)
    classes = config["n_classes"] + 1
    for (src, ch), n in zip(sources, boxes_per_cell(config)):
        table.append((f"{src}_mbox_conf", ch, n * classes, 3, 1, 1, 1))
        table.append((f"{src}_mbox_loc", ch, n * 4, 3, 1, 1, 1))
    return table


def feature_sizes(config: dict, extras: List[Conv],
                  sources: List[Tuple[str, int]]) -> Dict[str, Tuple[int, int]]:
    h, w = config["img_height"], config["img_width"]
    sizes = {}
    for name, _, _, k, s, p, d in TRUNK + list(extras):
        h, w = conv_out(h, k, s, p, d), conv_out(w, k, s, p, d)
        sizes[name] = (h, w)
        if name in POOL_AFTER:  # 2x2/2, ceil: pads at the end on odd maps
            h, w = -(-h // 2), -(-w // 2)
    sizes["conv4_3_norm"] = sizes["conv4_3"]
    for src, _ in sources:  # 3x3, stride 1, padding 1: the source's size
        sizes[f"{src}_mbox_conf"] = sizes[f"{src}_mbox_loc"] = sizes[src]
    return sizes


def parameters(config: dict, extras: List[Conv], sources: List[Tuple[str, int]]) -> dict:
    params = {}
    for name, cin, cout, k, _, _, _ in conv_table(config, extras, sources):
        scale = 0.01 if name == "conv1_1" else 0.25 if name.endswith("_mbox_loc") else 1.0
        params[f"{name}.weight"] = ((cout, cin, k, k), ("he_normal", scale))
        params[f"{name}.bias"] = ((cout,), ("constant", 0.0))
    params["conv4_3_norm.gamma"] = ((512,), ("constant", L2_GAMMA))
    return params


def forward(config: dict, params: Dict[str, torch.Tensor], images: torch.Tensor,
            extras: List[Conv], sources: List[Tuple[str, int]],
            quantize: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    x = images.float() - torch.tensor(config["subtract_mean"], device=images.device)
    x = x[..., list(config["swap_channels"])].permute(0, 3, 1, 2)
    feats = {}

    def conv(x, name, stride, pad, dil):
        w, b = params[f"{name}.weight"].float(), params[f"{name}.bias"].float()
        return F.conv2d(_quantize(x, quantize), _quantize(w, quantize), b, stride, pad, dil)

    for name, _, _, _, s, p, d in TRUNK + list(extras):
        x = F.relu(conv(x, name, s, p, d))
        feats[name] = x
        if name in POOL_AFTER:
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        if name == "conv5_3":
            x = F.max_pool2d(x, 3, 1, padding=1)
    c43 = feats["conv4_3"]
    norm = torch.sqrt(torch.clamp_min((c43 * c43).sum(1, keepdim=True), 1e-12))
    feats["conv4_3_norm"] = c43 / norm * params["conv4_3_norm.gamma"].float()[None, :, None, None]
    classes = config["n_classes"] + 1
    b = images.shape[0]
    confs, locs = [], []
    for src, _ in sources:
        f = feats[src]
        conf = conv(f, f"{src}_mbox_conf", 1, 1, 1)
        confs.append(conf.permute(0, 2, 3, 1).reshape(b, -1, classes))
        locs.append(conv(f, f"{src}_mbox_loc", 1, 1, 1).permute(0, 2, 3, 1).reshape(b, -1, 4))
    return torch.softmax(torch.cat(confs, 1), -1), torch.cat(locs, 1)
