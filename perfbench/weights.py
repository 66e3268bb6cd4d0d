"""Seeded SSD weights, made on the card in a few calls and handed alike to
the program and to the reference.

He-normal kernels truncated at two standard deviations (the flax and Keras
``he_normal``: std sqrt(2 / fan_in) / 0.8796), zero biases, the L2 norm's
scale at 20. Then, so that the outputs sit in a trained detector's range,
conv1_1 is scaled by 1/100 (raw He init carries the 0-255 input's
magnitude through the trunk and saturates the softmax) and the box heads
by 1/4 (encoded offsets of ~0.4 RMS keep each box near its anchor): the
arithmetic of the port's ``examples/common.py:scale_to_trained_range``,
frozen here.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference.ssd import L2_GAMMA, parameter_shapes

HE_TRUNCATED_STD = 0.87962566103423978


def seeded(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``config``'s network, float32 on ``device``."""
    shapes = parameter_shapes(config)
    kernels = {k: s for k, s in shapes.items() if k.endswith(".weight")}
    total = sum(math.prod(s) for s in kernels.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in kernels:
            n = math.prod(shape)
            std = math.sqrt(2.0 / (shape[1] * shape[2] * shape[3])) / HE_TRUNCATED_STD
            if name == "conv1_1.weight":
                std *= 0.01
            elif name.endswith("_mbox_loc.weight"):
                std *= 0.25
            out[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
        elif name == "conv4_3_norm.gamma":
            out[name] = torch.full(shape, L2_GAMMA, dtype=torch.float32, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out
