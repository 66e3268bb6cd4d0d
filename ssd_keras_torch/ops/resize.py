"""OpenCV's uint8 ``INTER_LINEAR`` resize over a packed batch, in plain
PyTorch: the reference of the CUDA kernel ``csrc/resize_linear.cu``.

A batch is what the JPEG colour kernel writes (``ops/jpeg_color.py``): one
flat uint8 ``pixels`` buffer and its ``layout``, one int64 row of
``jpeg_color.LAYOUT_FIELDS`` an image, of which the height, width, kind and
``out_offset`` are read here (a gray image is H x W bytes, any other H x W
x 3 interleaved RGB). Each image is resized to ``out_h`` x ``out_w`` in
``data/geometric.py``'s uint8 linear arithmetic (OpenCV's: 11-bit weights
from ``linear_taps_u8``, an int32 horizontal pass, then ``((b0 * (S0 >> 4))
>> 16 + (b1 * (S1 >> 4)) >> 16 + 2) >> 2``), into one (n, out_h, out_w, 3)
uint8 batch; a gray image fills all three channels, as ``ConvertTo3Channels``
then ``Resize`` give. Integer ops only, so it equals
``geometric.resize_image`` bit for bit wherever that takes ``_linear``
(``geometric.routes_to_linear``).
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_keras_torch.data.geometric import linear_taps_u8
from ssd_keras_torch.ops import jpeg_color

__all__ = ["check_layout", "taps", "resize_linear_u8"]

_F = {name: i for i, name in enumerate(jpeg_color.LAYOUT_FIELDS)}


def check_layout(layout: torch.Tensor, pixels_bytes: int) -> np.ndarray:
    """``layout`` (a CPU int64 (n, 9) tensor) as a NumPy array, checked:
    known kinds, positive sizes, and each image's pixels inside the
    ``pixels_bytes`` of the buffer. Raises ``ValueError``."""
    if layout.device.type != "cpu" or layout.dtype != torch.int64:
        raise ValueError(f"layout must be a CPU int64 tensor, got {layout.dtype} on "
                         f"{layout.device}")
    rows = layout.numpy()
    if rows.ndim != 2 or rows.shape[1] != len(jpeg_color.LAYOUT_FIELDS):
        raise ValueError(f"layout: expected shape (n, {len(jpeg_color.LAYOUT_FIELDS)}), "
                         f"got {rows.shape}")
    for k, row in enumerate(rows):
        h, w, kind, off = (int(row[_F[f]]) for f in ("height", "width", "kind", "out_offset"))
        if kind not in (jpeg_color.KIND_GRAY, jpeg_color.KIND_444, jpeg_color.KIND_422,
                        jpeg_color.KIND_420) or h < 1 or w < 1:
            raise ValueError(f"layout row {k}: kind {kind}, {h} x {w}")
        size = h * w * (1 if kind == jpeg_color.KIND_GRAY else 3)
        if off < 0 or off + size > pixels_bytes:
            raise ValueError(f"layout row {k}: its pixels lie outside the {pixels_bytes} bytes")
    return rows


def taps(in_h: int, in_w: int, out_h: int, out_w: int) -> np.ndarray:
    """The int32 table of an ``in_h`` x ``in_w`` -> ``out_h`` x ``out_w``
    resize, as the kernel reads it: x0, x1, a0, a1 (``out_w`` each), then
    y0, y1, b0, b1 (``out_h`` each)."""
    return np.concatenate([*linear_taps_u8(in_w, out_w, True),
                           *linear_taps_u8(in_h, out_h, False)]).astype(np.int32)


def resize_linear_u8(pixels: torch.Tensor, layout: torch.Tensor, out_h: int,
                     out_w: int) -> torch.Tensor:
    """The (n, out_h, out_w, 3) uint8 batch on ``pixels``' device: each
    image of ``layout`` resized as ``geometric.resize_image`` resizes uint8
    in ``INTER_LINEAR`` (gray images to three equal channels)."""
    if out_h < 1 or out_w < 1:
        raise ValueError(f"output size {out_h} x {out_w}")
    rows = check_layout(layout, pixels.numel())
    dev = pixels.device
    out = torch.empty((len(rows), out_h, out_w, 3), dtype=torch.uint8, device=dev)
    for k, row in enumerate(rows):
        h, w, kind, off = (int(row[_F[f]]) for f in ("height", "width", "kind", "out_offset"))
        c = 1 if kind == jpeg_color.KIND_GRAY else 3
        src = pixels[off:off + h * w * c].view(h, w, c).to(torch.int32)
        t = torch.from_numpy(taps(h, w, out_h, out_w)).to(dev)
        x0, x1, a0, a1 = t[:4 * out_w].view(4, out_w)
        y0, y1, b0, b1 = t[4 * out_w:].view(4, out_h)
        sums = src[:, x0.long()] * a0[None, :, None] + src[:, x1.long()] * a1[None, :, None]
        top = (b0[:, None, None] * (sums[y0.long()] >> 4)) >> 16
        bottom = (b1[:, None, None] * (sums[y1.long()] >> 4)) >> 16
        out[k] = ((top + bottom + 2) >> 2).clamp(0, 255).to(torch.uint8)
    return out
