"""Seeded SSD weights, made on the card in a few calls and handed alike to
the program and to the reference.

One flat draw, truncated at two standard deviations, over every kernel of
the architecture (the parameters whose rule is ``("he_normal", scale)``),
in the order the architecture lists them; each kernel is its slice of the
draw times the He standard deviation, sqrt(2 / fan_in) / 0.8796 (the flax
and Keras ``he_normal``), times its ``scale``. Every other parameter is
its rule's ``("constant", value)``. The architecture file
(``perfbench/architectures/<architecture>.py``) gives the rules.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference.ssd import parameters

HE_TRUNCATED_STD = 0.87962566103423978


def seeded(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``config``'s network, float32 on ``device``."""
    params = parameters(config)
    kernels = {k: shape for k, (shape, (rule, _)) in params.items() if rule == "he_normal"}
    total = sum(math.prod(s) for s in kernels.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for name, (shape, (rule, value)) in params.items():
        if rule == "he_normal":
            n = math.prod(shape)
            std = math.sqrt(2.0 / math.prod(shape[1:])) / HE_TRUNCATED_STD * value
            out[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
        elif rule == "constant":
            out[name] = torch.full(shape, value, dtype=torch.float32, device=device)
        else:
            raise ValueError(f"{name}: no initialisation rule {rule!r}")
    return out
