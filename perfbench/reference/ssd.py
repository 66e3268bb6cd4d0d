"""The SSD reference in plain PyTorch, whatever the architecture: the
anchors, the decode of box offsets, the resizes, and the reduced-precision
rounding of the control. What depends on the architecture (its
convolutions, feature sizes, parameters and forward pass) is in
``perfbench/architectures/<architecture>.py``, found by the configuration's
``architecture``; the functions here of the same names forward to it.

An architecture file gives:

- ``conv_table(config)``: every convolution, heads included, as
  (name, in, out, kernel, stride, padding, dilation), the first the one
  that reads the image;
- ``feature_sizes(config)``: the (height, width) of every convolution's
  output and of each predictor source;
- ``sources(config)``: (feature, channels) of each predictor layer, in the
  anchors' order;
- ``parameters(config)``: each parameter's shape and initialisation rule
  by its name in the port's state dict, in the order the weights are
  drawn: ``("he_normal", scale)`` (a truncated He-normal kernel, its
  standard deviation times ``scale``) or ``("constant", value)`` (a bias,
  a norm's scale, a BatchNorm's weight, bias, running mean or variance);
- ``forward(config, params, images, quantize=None)``: class scores
  (B, N, classes) after the softmax and box offsets (B, N, 4) for float32
  images (B, H, W, 3) in 0-255, in float32, preprocessing included;
- ``PORT_BUILDER``: the port's builder as ``"module:function"``.

``forward(..., quantize=torch.float8_e4m3fn)`` rounds every convolution's
input and weight to that type (one scale a tensor, its largest magnitude
at the type's largest finite value) and computes in float32, the gradient
passing the rounding straight through: the reference in a lower
precision, the control of the comparison that decides ``correct``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import harness


@functools.lru_cache(maxsize=None)
def _load(root: str, name: str):
    return harness.load_module("architectures", name)


def architecture(config: dict):
    """The module ``architectures/<config["architecture"]>.py``, loaded once
    a benchmark root."""
    return _load(str(harness.ROOT), config["architecture"])


def boxes_per_cell(config: dict) -> List[int]:
    return [len(ars) + (1 if 1.0 in ars and config["two_boxes_for_ar1"] else 0)
            for ars in config["aspect_ratios"]]


def conv_out(size: int, k: int, s: int, p: int, d: int) -> int:
    """A convolution's output length along one axis."""
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def conv_table(config: dict) -> List[Tuple[str, int, int, int, int, int, int]]:
    """Every convolution of the network, heads included, as
    (name, in, out, kernel, stride, padding, dilation)."""
    return architecture(config).conv_table(config)


def feature_sizes(config: dict) -> Dict[str, Tuple[int, int]]:
    """The (height, width) of every convolution's output and source."""
    return architecture(config).feature_sizes(config)


def predictor_sizes(config: dict) -> List[Tuple[int, int]]:
    sizes = feature_sizes(config)
    return [sizes[src] for src, _ in architecture(config).sources(config)]


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


def parameters(config: dict) -> Dict[str, tuple]:
    """Every parameter's (shape, initialisation rule), in draw order."""
    return architecture(config).parameters(config)


def parameter_shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the network by its name in the port's state dict."""
    return {name: shape for name, (shape, _) in parameters(config).items()}


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
    return architecture(config).forward(config, params, images, quantize)


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
    H100 (a loss 0.3% off and bias gradients of ~5e5 on the 300x300 training
    cell at batch 32, where the CPU and PyTorch's own CUDA convolutions
    agree)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = False
