"""A convolution's epilogue, bias, residual and ReLU in one in-place pass,
and its pooled variant: the CUDA kernels ``csrc/conv_epilogue.cu`` and
their wrappers.

Every convolution of the port's no-grad path (serving, evaluation) runs
without its bias and then through here (``models/layers.py:
conv2d_epilogue``), in place of PyTorch's broadcast bias ``add_``, its ReLU
and a residual block's ``add_``. A convolution that feeds only a max pool
after its ReLU takes the pooled variant, which writes the pooled map in
place of the full-size one and of PyTorch's max pool. Not the port of a
TPU kernel: XLA fuses these ops into the JAX package's convolutions.

What bounds them on the card: the bytes, each element of the map read once
and written once (the pooled variant: the pooled map written), and the
residual read once (see the source's header).

Dispatch is by the tensors' device and nothing else: CPU tensors go to the
plain PyTorch versions (``ops/conv_epilogue.py``); CUDA tensors launch the
kernel or raise. The counter ``conv_epilogue.launches``
(``utils.profiling.count``) counts the calls that launched either kernel,
``conv_epilogue.pooled`` those of the pooled variant; a call under
CUDA-graph capture counts at each replay (``utils/cuda_graph.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ssd_keras_torch.kernels.build import launch
from ssd_keras_torch.ops import conv_epilogue as plain
from ssd_keras_torch.ops.conv_epilogue import MaxPool
from ssd_keras_torch.utils.profiling import count

__all__ = ["conv_epilogue", "conv_epilogue_pool"]

# The C entry's dtype codes (csrc/conv_epilogue.cu:Dtype).
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# The pooled kernel's (window, stride): the models' pools.
_POOL_GEOMETRIES = {(2, 2), (3, 1), (3, 2)}


def _inner(y: torch.Tensor) -> int:
    """Elements of one channel's plane in ``y``'s memory: 1 where a pixel's
    channels lie next to each other (channels_last, or no plane at all),
    else the plane of a contiguous NCHW map. Raises on another layout."""
    if y.is_contiguous():
        return 1 if y.shape[1] == 1 else math.prod(y.shape[2:])
    if y.dim() == 4 and y.is_contiguous(memory_format=torch.channels_last):
        return 1
    raise ValueError(f"y must be contiguous or channels_last, got strides {y.stride()} for "
                     f"shape {tuple(y.shape)}")


def _check(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor]) -> int:
    """Raises unless the kernel takes these tensors; returns ``_inner(y)``."""
    if y.dtype not in _DTYPES:
        raise TypeError(f"y must be float32, float16 or bfloat16, got {y.dtype}")
    if y.dim() < 2:
        raise ValueError(f"y must be (N, C, ...), got shape {tuple(y.shape)}")
    if bias.dtype != y.dtype or bias.shape != y.shape[1:2] or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous ({y.shape[1]},) {y.dtype} tensor, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if bias.device != y.device:
        raise ValueError(f"bias on {bias.device} but y on {y.device}")
    if residual is not None:
        if residual.dtype != y.dtype or residual.shape != y.shape:
            raise ValueError(f"residual must be {tuple(y.shape)} {y.dtype}, got "
                             f"{tuple(residual.shape)} {residual.dtype}")
        if residual.device != y.device:
            raise ValueError(f"residual on {residual.device} but y on {y.device}")
        if any(a != b for a, b, n in zip(residual.stride(), y.stride(), y.shape) if n > 1):
            raise ValueError(f"residual's strides {residual.stride()} differ from y's "
                             f"{y.stride()}")
    return _inner(y)


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                  relu: bool = False) -> torch.Tensor:
    """``y <- relu?(y + bias[c] + residual?)`` in place, rounded to ``y``'s
    dtype as PyTorch's ``add_``, ``add_`` and ``relu_`` round; returns
    ``y``. ``y``: an (N, C, ...) float32, float16 or bfloat16 map,
    channels_last or contiguous; ``bias``: (C,) of its dtype; ``residual``:
    ``y``'s shape, dtype and strides. On the card one kernel launch on the
    current stream."""
    inner = _check(y, bias, residual)
    if y.device.type == "cpu":
        return plain.conv_epilogue(y, bias, residual, relu)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if y.numel() == 0:
        return y
    launch("ssd_conv_epilogue", y.device, y.data_ptr(), bias.data_ptr(),
           None if residual is None else residual.data_ptr(), _DTYPES[y.dtype], y.numel(),
           y.shape[1], inner, int(relu))
    count("conv_epilogue.launches")
    return y


def _check_pool(y: torch.Tensor, bias: torch.Tensor, pool: MaxPool) -> tuple:
    """Raises unless the pooled kernel takes these tensors and this pool;
    returns the pooled map's (height, width)."""
    _check(y, bias, None)
    if y.dim() != 4 or not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"y must be a channels_last (N, C, H, W) map, got shape "
                         f"{tuple(y.shape)} strides {y.stride()}")
    window, stride, padding, _ = pool
    if (window, stride) not in _POOL_GEOMETRIES or not 0 <= padding < window / 2:
        raise ValueError(f"the pooled epilogue takes 2x2 windows at stride 2 and 3x3 at stride "
                         f"1 or 2, with padding under half the window, got {pool}")
    out = tuple(pool.output_size(s) for s in y.shape[2:])
    if min(out) < 1:
        raise ValueError(f"{pool} leaves nothing of a {tuple(y.shape[2:])} map")
    return out


def conv_epilogue_pool(y: torch.Tensor, bias: torch.Tensor, pool: MaxPool) -> torch.Tensor:
    """``pool(relu(y + bias[c]))`` in one pass, equal bit for bit to
    ``conv_epilogue(y, bias, relu=True)`` then ``F.max_pool2d`` of ``pool``'s
    geometry; returns the pooled map, a new channels_last tensor, and leaves
    ``y`` as it is. ``y``: a channels_last (N, C, H, W) float32, float16 or
    bfloat16 map; ``bias``: (C,) of its dtype; ``pool``: a 2x2 window at
    stride 2 or a 3x3 one at stride 1 or 2, padding under half the window,
    ``ceil_mode`` either.
    On the card one kernel launch on the current stream."""
    out_hw = _check_pool(y, bias, pool)
    if y.device.type == "cpu":
        return plain.conv_epilogue_pool(y, bias, pool)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    out = torch.empty(y.shape[:2] + out_hw, dtype=y.dtype, device=y.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    n, c, h, w = y.shape
    launch("ssd_conv_epilogue_pool", y.device, y.data_ptr(), bias.data_ptr(), out.data_ptr(),
           _DTYPES[y.dtype], n, c, h, w, *out_hw, pool.window, pool.stride, pool.padding)
    count("conv_epilogue.launches")
    count("conv_epilogue.pooled")
    return out
