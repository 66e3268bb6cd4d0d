"""A convolution's epilogue in plain PyTorch: the reference of the CUDA
kernels ``csrc/conv_epilogue.cu``.

``y <- relu?(round(round(y + bias[c]) + residual?))`` in place, in the
steps PyTorch takes for ``y.add_(bias.view(1, C, 1, 1))``,
``y.add_(residual)`` and ``y.relu_()``: each sum in float32 of the working
type's values, rounded to the working type (bf16, fp16 or float32) after
the bias and again after the residual, then ``torch.relu``. ``y`` is an
(N, C, ...) map, ``bias`` (C,) and ``residual`` of ``y``'s shape.

The pooled epilogue is that epilogue with the ReLU (and no residual),
then ``F.max_pool2d`` of the geometry a :class:`MaxPool` names, into a
new channels_last map.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

__all__ = ["MaxPool", "conv_epilogue", "conv_epilogue_pool"]


class MaxPool(NamedTuple):
    """A max pool's geometry, as ``F.max_pool2d`` takes it; calling it
    pools a map."""

    window: int
    stride: int
    padding: int = 0
    ceil_mode: bool = False

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.window, self.stride, self.padding, ceil_mode=self.ceil_mode)

    def output_size(self, size: int) -> int:
        """The pooled size of a side of ``size``, as PyTorch computes it: with
        ``ceil_mode`` the last window must start inside the map or its left
        padding."""
        extra = self.stride - 1 if self.ceil_mode else 0
        out = (size + 2 * self.padding - self.window + extra) // self.stride + 1
        if self.ceil_mode and (out - 1) * self.stride >= size + self.padding:
            out -= 1
        return out


def _epilogue(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
              relu: bool) -> torch.Tensor:
    shape = (1, -1) + (1,) * (y.dim() - 2)
    t = (y.float() + bias.float().view(shape)).to(y.dtype)
    if residual is not None:
        t = (t.float() + residual.float()).to(y.dtype)
    return torch.relu(t) if relu else t


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                  relu: bool = False) -> torch.Tensor:
    """``y`` with the bias, the residual and the ReLU applied, in place."""
    return y.copy_(_epilogue(y, bias, residual, relu))


def conv_epilogue_pool(y: torch.Tensor, bias: torch.Tensor, pool: MaxPool) -> torch.Tensor:
    """``pool(relu(y + bias[c]))``, a new channels_last map; ``y`` is left
    as it is."""
    return pool(_epilogue(y, bias, None, True)).contiguous(memory_format=torch.channels_last)
