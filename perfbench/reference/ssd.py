"""SSD300 and SSD512 (Liu et al., arXiv:1512.02325) in plain PyTorch.

The layer tables, the anchors and the forward pass follow the paper's
Caffe models as ssd_keras builds them (``keras_ssd300.py``,
``keras_ssd512.py``): VGG-16 to conv5_3 with 2x2 max pools that pad at the
end on odd maps, pool5 3x3 stride 1, fc6 3x3 dilation 6, fc7 1x1, the extra
layers, conv4_3 L2-normalised with a learned per-channel scale (ParseNet),
and one 3x3 class head and one 3x3 box head a predictor layer. Input is
(B, H, W, 3) RGB in 0-255; the Caffe preprocessing subtracts the mean and
swaps to BGR. Class scores are the softmax over the classes, background
first.

``forward(..., quantize=torch.float8_e4m3fn)`` rounds every convolution's
input and weight to that type (one scale a tensor, its largest magnitude
at the type's largest finite value) and computes in float32, the gradient
passing the rounding straight through: the reference in a lower
precision, the control of the comparison that decides ``correct``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# (name, in, out, kernel, stride, padding, dilation), in graph order.
_VGG = [
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
_EXTRAS = {
    "ssd300": [("conv8_1", 256, 128, 1, 1, 0, 1), ("conv8_2", 128, 256, 3, 1, 0, 1),
               ("conv9_1", 256, 128, 1, 1, 0, 1), ("conv9_2", 128, 256, 3, 1, 0, 1)],
    "ssd512": [("conv8_1", 256, 128, 1, 1, 0, 1), ("conv8_2", 128, 256, 3, 2, 1, 1),
               ("conv9_1", 256, 128, 1, 1, 0, 1), ("conv9_2", 128, 256, 3, 2, 1, 1),
               ("conv10_1", 256, 128, 1, 1, 0, 1), ("conv10_2", 128, 256, 4, 1, 1, 1)],
}
# (feature, its channels) of each predictor layer.
_SOURCES = {
    "ssd300": [("conv4_3_norm", 512), ("fc7", 1024), ("conv6_2", 512), ("conv7_2", 256),
               ("conv8_2", 256), ("conv9_2", 256)],
    "ssd512": [("conv4_3_norm", 512), ("fc7", 1024), ("conv6_2", 512), ("conv7_2", 256),
               ("conv8_2", 256), ("conv9_2", 256), ("conv10_2", 256)],
}
# The layers after which a 2x2/2 pool follows ("pool4" feeds conv5_1).
_POOL_AFTER = {"conv1_2", "conv2_2", "conv3_3", "conv4_3"}
L2_GAMMA = 20.0


def boxes_per_cell(config: dict) -> List[int]:
    return [len(ars) + (1 if 1.0 in ars and config["two_boxes_for_ar1"] else 0)
            for ars in config["aspect_ratios"]]


def conv_table(config: dict) -> List[Tuple[str, int, int, int, int, int, int]]:
    """Every convolution of the network, heads included, as
    (name, in, out, kernel, stride, padding, dilation)."""
    arch = config["architecture"]
    table = list(_VGG) + list(_EXTRAS[arch])
    classes = config["n_classes"] + 1
    for (src, ch), n in zip(_SOURCES[arch], boxes_per_cell(config)):
        table.append((f"{src}_mbox_conf", ch, n * classes, 3, 1, 1, 1))
        table.append((f"{src}_mbox_loc", ch, n * 4, 3, 1, 1, 1))
    return table


def _out(size: int, k: int, s: int, p: int, d: int) -> int:
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def feature_sizes(config: dict) -> Dict[str, Tuple[int, int]]:
    """The (height, width) of every convolution's output."""
    h, w = config["img_height"], config["img_width"]
    sizes = {}
    for name, _, _, k, s, p, d in _VGG + _EXTRAS[config["architecture"]]:
        h, w = _out(h, k, s, p, d), _out(w, k, s, p, d)
        sizes[name] = (h, w)
        if name in _POOL_AFTER:  # 2x2/2, ceil: pads at the end on odd maps
            h, w = -(-h // 2), -(-w // 2)
    sizes["conv4_3_norm"] = sizes["conv4_3"]
    return sizes


def predictor_sizes(config: dict) -> List[Tuple[int, int]]:
    sizes = feature_sizes(config)
    return [sizes[src] for src, _ in _SOURCES[config["architecture"]]]


def anchors(config: dict) -> np.ndarray:
    """(N, 8) float64: each anchor's normalised (cx, cy, w, h) and the four
    variances, C-order over each layer's (rows, columns, boxes), layers in
    order. Sizes scale the shorter side; an aspect ratio of 1 adds a box of
    the geometric mean of this layer's and the next layer's scale."""
    img_h, img_w = config["img_height"], config["img_width"]
    size = min(img_h, img_w)
    scales = config["scales"]
    out = []
    for i, ((fh, fw), ars) in enumerate(zip(predictor_sizes(config), config["aspect_ratios"])):
        wh = []
        for ar in ars:
            if ar == 1.0:
                wh.append((scales[i] * size, scales[i] * size))
                if config["two_boxes_for_ar1"]:
                    g = math.sqrt(scales[i] * scales[i + 1]) * size
                    wh.append((g, g))
            else:
                wh.append((scales[i] * size * math.sqrt(ar), scales[i] * size / math.sqrt(ar)))
        wh = np.array(wh)
        step, off = config["steps"][i], config["offsets"][i]
        cy = np.linspace(off * step, (off + fh - 1) * step, fh)
        cx = np.linspace(off * step, (off + fw - 1) * step, fw)
        gx, gy = np.meshgrid(cx, cy)
        grid = np.zeros((fh, fw, len(wh), 4))
        grid[..., 0], grid[..., 1] = gx[..., None], gy[..., None]
        grid[..., 2], grid[..., 3] = wh[:, 0], wh[:, 1]
        # Through corners and back, as ssd_keras does ('half' border).
        x1, y1 = grid[..., 0] - grid[..., 2] / 2, grid[..., 1] - grid[..., 3] / 2
        x2, y2 = grid[..., 0] + grid[..., 2] / 2, grid[..., 1] + grid[..., 3] / 2
        x1, x2, y1, y2 = x1 / img_w, x2 / img_w, y1 / img_h, y2 / img_h
        cen = np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)
        out.append(cen.reshape(-1, 4))
    a = np.concatenate(out)
    var = np.broadcast_to(np.asarray(config["variances"], np.float64), a.shape)
    return np.concatenate([a, var], axis=1)


def parameter_shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the network by its ssd_keras layer name."""
    shapes = {}
    for name, cin, cout, k, _, _, _ in conv_table(config):
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        shapes[f"{name}.bias"] = (cout,)
    shapes["conv4_3_norm.gamma"] = (512,)
    return shapes


def _quantize(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``t`` rounded to ``dtype``, with one scale (its largest magnitude at
    the type's largest finite value) where the type's range is narrower
    than float32's; the gradient passes straight through in float32."""
    if dtype is None:
        return t
    top = torch.finfo(dtype).max
    if top >= torch.finfo(torch.float32).max / 2:  # bfloat16: float32's exponents
        rounded = t.detach().to(dtype).to(torch.float32)
    else:
        scale = t.detach().abs().amax().clamp_min(1e-30) / top
        rounded = (t.detach() / scale).to(dtype).to(torch.float32) * scale
    return t + (rounded - t.detach())


def forward(config: dict, params: Dict[str, torch.Tensor], images: torch.Tensor,
            quantize: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class scores (B, N, classes) after the softmax and box offsets
    (B, N, 4) for float32 images (B, H, W, 3) in 0-255, in float32."""
    arch = config["architecture"]
    x = images.float() - torch.tensor(config["subtract_mean"], device=images.device)
    x = x[..., list(config["swap_channels"])].permute(0, 3, 1, 2)
    feats = {}

    def conv(x, name, stride, pad, dil):
        w, b = params[f"{name}.weight"].float(), params[f"{name}.bias"].float()
        return F.conv2d(_quantize(x, quantize), _quantize(w, quantize), b, stride, pad, dil)

    for name, _, _, _, s, p, d in _VGG + _EXTRAS[arch]:
        x = F.relu(conv(x, name, s, p, d))
        feats[name] = x
        if name in _POOL_AFTER:
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        if name == "conv5_3":
            x = F.max_pool2d(x, 3, 1, padding=1)
    c43 = feats["conv4_3"]
    norm = torch.sqrt(torch.clamp_min((c43 * c43).sum(1, keepdim=True), 1e-12))
    feats["conv4_3_norm"] = c43 / norm * params["conv4_3_norm.gamma"].float()[None, :, None, None]
    classes = config["n_classes"] + 1
    b = images.shape[0]
    confs, locs = [], []
    for src, _ in _SOURCES[arch]:
        f = feats[src]
        conf = conv(f, f"{src}_mbox_conf", 1, 1, 1)
        confs.append(conf.permute(0, 2, 3, 1).reshape(b, -1, classes))
        locs.append(conv(f, f"{src}_mbox_loc", 1, 1, 1).permute(0, 2, 3, 1).reshape(b, -1, 4))
    return torch.softmax(torch.cat(confs, 1), -1), torch.cat(locs, 1)


def decode_boxes(config: dict, offsets: torch.Tensor, anchor8: torch.Tensor) -> torch.Tensor:
    """Box offsets (B, N, 4) to corners (B, N, 4) in the model's pixel
    frame: the centroid encoding with its variances, inverted."""
    a, v = anchor8[:, :4], anchor8[:, 4:]
    cx = offsets[..., 0] * v[:, 0] * a[:, 2] + a[:, 0]
    cy = offsets[..., 1] * v[:, 1] * a[:, 3] + a[:, 1]
    w = torch.exp(offsets[..., 2] * v[:, 2]) * a[:, 2]
    h = torch.exp(offsets[..., 3] * v[:, 3]) * a[:, 3]
    W, H = config["img_width"], config["img_height"]
    return torch.stack([(cx - w / 2) * W, (cy - h / 2) * H, (cx + w / 2) * W, (cy + h / 2) * H], -1)


def resize_antialiased(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """uint8 (B, h, w, 3) to float32 (B, height, width, 3): the triangle
    filter widened by the reduction factor (PIL's BILINEAR)."""
    x = images.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(height, width), mode="bilinear", antialias=True,
                      align_corners=False)
    return x.permute(0, 2, 3, 1)


def resize_linear_uint8(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """OpenCV's INTER_LINEAR on a uint8 (h, w, 3) image: half-pixel centres,
    two taps an axis, no widening, rounded back to uint8."""
    x = torch.from_numpy(np.array(image, np.float32)).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False)
    return x[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def exact_float32() -> None:
    """Float32 arithmetic for what follows: TF32 off, and cuDNN off, whose
    float32 training convolutions with TF32 off give wrong results on the
    H100 (a loss 0.3% off and bias gradients of ~5e5 on SSD300 at batch 32,
    where the CPU and PyTorch's own CUDA convolutions agree)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = False
