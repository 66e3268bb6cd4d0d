"""OpenCV's uint8 ``INTER_LINEAR`` resize of a packed batch of decoded JPEG
pixels: the CUDA kernel ``csrc/resize_linear.cu`` and its wrapper.

The evaluator's 'resize' mode keeps a JPEG batch on the card with it: nvJPEG
and the colour kernel (``kernels/jpeg_color.py``) write the pixels packed,
and one launch resizes them all into the (B, out_h, out_w, 3) uint8 batch
the model takes (``data/datasets.py``). Not the port of a TPU kernel: the
JAX package resizes on its host with OpenCV.

What bounds it on the card: the bytes (each source pixel read once, each
output pixel written once; about 1.35 MB an image from 500 x 375 to 512 x
512). Each image's taps table (``ops/resize.py:taps``) is built on the host
once per (in_h, in_w, out_h, out_w) and kept on the card (``TAPS_KEPT``
tables, the least recently used dropped first); a table of one int64 row an
image (``IMAGE_FIELDS``: its pixels' offset, height, width, channels and
its taps' address) goes up from pinned memory without a wait.

Dispatch is by the tensors' device and nothing else: CPU tensors go to the
plain PyTorch version (``ops/resize.py:resize_linear_u8``); CUDA tensors
launch the kernel or raise. The counter ``resize_linear.launches``
(``utils.profiling.count``) counts the calls that launched it.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ssd_keras_torch.kernels.build import launch
from ssd_keras_torch.ops import jpeg_color
from ssd_keras_torch.ops import resize as plain
from ssd_keras_torch.utils.profiling import count

__all__ = ["resize_linear_u8"]

IMAGE_FIELDS = ("offset", "height", "width", "channels", "taps")
TAPS_KEPT = 64
# (in_h, in_w, out_h, out_w, card) -> the taps on that card.
_TAPS: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
# The grid's image axis (CUDA's gridDim.y).
MAX_IMAGES = 65535
_F = {name: i for i, name in enumerate(jpeg_color.LAYOUT_FIELDS)}


def _device_taps(in_h: int, in_w: int, out_h: int, out_w: int,
                 device: torch.device) -> torch.Tensor:
    """The taps table of one resize on ``device`` (a card), from the cache
    or built and kept."""
    key = (in_h, in_w, out_h, out_w, device.index)
    table = _TAPS.get(key)
    if table is None:
        table = torch.from_numpy(plain.taps(in_h, in_w, out_h, out_w)).to(device)
        _TAPS[key] = table
        while len(_TAPS) > TAPS_KEPT:
            _TAPS.popitem(last=False)
    else:
        _TAPS.move_to_end(key)
    return table


def resize_linear_u8(pixels: torch.Tensor, layout: torch.Tensor, out_h: int,
                     out_w: int) -> torch.Tensor:
    """The (n, out_h, out_w, 3) uint8 batch on ``pixels``' device: each
    image of ``layout`` (``ops/resize.py``) resized in OpenCV's uint8
    linear arithmetic, gray images to three equal channels. On the card:
    one kernel launch on the current stream, counted in
    ``resize_linear.launches``."""
    if pixels.dtype != torch.uint8 or pixels.dim() != 1 or not pixels.is_contiguous():
        raise ValueError(f"pixels must be a contiguous 1-D uint8 tensor, got {pixels.dtype} "
                         f"{tuple(pixels.shape)}")
    if pixels.device.type == "cpu":
        return plain.resize_linear_u8(pixels, layout, out_h, out_w)
    if pixels.device.type != "cuda":
        raise ValueError(f"unsupported device {pixels.device}")
    if out_h < 1 or out_w < 1:
        raise ValueError(f"output size {out_h} x {out_w}")
    rows = plain.check_layout(layout, pixels.numel())
    if len(rows) > MAX_IMAGES:
        raise ValueError(f"{len(rows)} images exceed the kernel's grid ({MAX_IMAGES})")
    out = torch.empty((len(rows), out_h, out_w, 3), dtype=torch.uint8, device=pixels.device)
    if len(rows) == 0:
        return out
    images = np.empty((len(rows), len(IMAGE_FIELDS)), dtype=np.int64)
    stream = torch.cuda.current_stream(pixels.device)
    for k, row in enumerate(rows):
        h, w = int(row[_F["height"]]), int(row[_F["width"]])
        taps = _device_taps(h, w, out_h, out_w, pixels.device)
        taps.record_stream(stream)  # a table dropped from the cache waits for this launch
        images[k] = (row[_F["out_offset"]], h, w,
                     1 if row[_F["kind"]] == jpeg_color.KIND_GRAY else 3, taps.data_ptr())
    table = torch.from_numpy(images).pin_memory().to(pixels.device, non_blocking=True)
    launch("ssd_resize_linear_u8", pixels.device, pixels.data_ptr(), table.data_ptr(), len(rows),
           out_h, out_w, out.data_ptr())
    count("resize_linear.launches")
    return out
