"""A convolution's epilogue in plain PyTorch: the reference of the CUDA
kernel ``csrc/conv_epilogue.cu``.

``y <- relu?(round(round(y + bias[c]) + residual?))`` in place, in the
steps PyTorch takes for ``y.add_(bias.view(1, C, 1, 1))``,
``y.add_(residual)`` and ``y.relu_()``: each sum in float32 of the working
type's values, rounded to the working type (bf16, fp16 or float32) after
the bias and again after the residual, then ``torch.relu``. ``y`` is an
(N, C, ...) map, ``bias`` (C,) and ``residual`` of ``y``'s shape.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["conv_epilogue"]


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                  relu: bool = False) -> torch.Tensor:
    """``y`` with the bias, the residual and the ReLU applied, in place."""
    shape = (1, -1) + (1,) * (y.dim() - 2)
    t = (y.float() + bias.float().view(shape)).to(y.dtype)
    if residual is not None:
        t = (t.float() + residual.float()).to(y.dtype)
    if relu:
        t = torch.relu(t)
    return y.copy_(t)
