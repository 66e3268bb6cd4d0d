"""libjpeg's chroma upsampling and YCbCr -> RGB conversion in plain PyTorch:
the reference of the CUDA kernel ``csrc/jpeg_color.cu``.

What libjpeg (and so PIL, and the JAX package's ``native/ssd_jpeg.cpp``)
computes from a JPEG's decoded planes, in its integer arithmetic: "fancy"
upsampling of 4:2:2 (``jdsample.c:h2v1_fancy_upsample``) and 4:2:0
(``h2v2_fancy_upsample``), plain replication where the chroma plane is two
samples wide or less, and ``jdcolor.c:ycc_rgb_convert`` with its 16-bit
fixed-point tables. Given libjpeg's own planes the result equals PIL's
decode bit for bit (``tests/test_torch_jpeg.py`` builds JPEGs whose planes
are known exactly). The card's decoder feeds it nvJPEG's planes
(``native/jpeg.py``).

A batch is one flat uint8 ``planes`` buffer and a ``layout``: one int64 row
of ``LAYOUT_FIELDS`` an image. Gray images (``KIND_GRAY``) give H x W bytes
(their Y plane), colour images H x W x 3 interleaved RGB, at ``out_offset``
in a flat uint8 output of ``out_bytes``. Plane pitches are the planes'
widths (the image's width for Y).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["LAYOUT_FIELDS", "KIND_GRAY", "KIND_444", "KIND_422", "KIND_420",
           "chroma_shape", "check_layout", "ycc_to_rgb"]

LAYOUT_FIELDS = ("y_offset", "cb_offset", "cr_offset", "chroma_width", "chroma_height",
                 "height", "width", "kind", "out_offset")
KIND_GRAY, KIND_444, KIND_422, KIND_420 = 0, 1, 2, 3
_F = {name: i for i, name in enumerate(LAYOUT_FIELDS)}


def chroma_shape(kind: int, height: int, width: int):
    """(height, width) of a chroma plane of ``kind`` for an image of
    ``height`` x ``width`` (libjpeg's ``downsampled_height/width``)."""
    if kind == KIND_444:
        return height, width
    if kind == KIND_422:
        return height, (width + 1) // 2
    if kind == KIND_420:
        return (height + 1) // 2, (width + 1) // 2
    raise ValueError(f"no chroma planes for kind {kind}")


def check_layout(layout: torch.Tensor, planes_bytes: int, out_bytes: int) -> np.ndarray:
    """``layout`` (a CPU int64 (n, 9) tensor) as a NumPy array, checked:
    known kinds, positive sizes, chroma planes of the kind's shape, and
    every plane and output inside its buffer. Raises ``ValueError``."""
    if layout.device.type != "cpu" or layout.dtype != torch.int64:
        raise ValueError(f"layout must be a CPU int64 tensor, got {layout.dtype} on "
                         f"{layout.device}")
    rows = layout.numpy()
    if rows.ndim != 2 or rows.shape[1] != len(LAYOUT_FIELDS):
        raise ValueError(f"layout: expected shape (n, {len(LAYOUT_FIELDS)}), got {rows.shape}")
    for k, row in enumerate(rows):
        y_off, cb_off, cr_off, cw, ch, h, w, kind, out_off = (int(v) for v in row)
        if kind not in (KIND_GRAY, KIND_444, KIND_422, KIND_420) or h < 1 or w < 1:
            raise ValueError(f"layout row {k}: kind {kind}, {h} x {w}")
        spans = [(y_off, h * w)]
        if kind != KIND_GRAY:
            if (ch, cw) != chroma_shape(kind, h, w):
                raise ValueError(f"layout row {k}: chroma {ch} x {cw} for a {h} x {w} image "
                                 f"of kind {kind}")
            spans += [(cb_off, ch * cw), (cr_off, ch * cw)]
        if any(off < 0 or off + size > planes_bytes for off, size in spans):
            raise ValueError(f"layout row {k}: a plane lies outside the {planes_bytes} bytes")
        size = h * w * (1 if kind == KIND_GRAY else 3)
        if out_off < 0 or out_off + size > out_bytes:
            raise ValueError(f"layout row {k}: its pixels lie outside the {out_bytes} bytes")
    return rows


def _upsample(plane: torch.Tensor, kind: int, h: int, w: int) -> torch.Tensor:
    """(h, w) int32 chroma from a (ch, cw) uint8 plane."""
    p = plane.to(torch.int32)
    if kind == KIND_444:
        return p
    ch, cw = p.shape
    dev = p.device
    c = torch.arange(w, device=dev)
    j = c // 2
    odd = (c % 2).bool()
    jn = torch.where(odd, (j + 1).clamp(max=cw - 1), (j - 1).clamp(min=0))
    if kind == KIND_422:
        if cw <= 2:
            return p[:, j]
        return (3 * p[:, j] + p[:, jn] + torch.where(odd, 2, 1)) >> 2
    r = torch.arange(h, device=dev)
    i = r // 2
    if cw <= 2:
        return p[i][:, j]
    i2 = torch.where((r % 2).bool(), (i + 1).clamp(max=ch - 1), (i - 1).clamp(min=0))
    s = 3 * p[i] + p[i2]  # (h, cw) column sums: 3 nearer row + 1 farther row
    return (3 * s[:, j] + s[:, jn] + torch.where(odd, 7, 8)) >> 4


def _convert(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """libjpeg's ``ycc_rgb_convert`` on int32 planes: (h, w, 3) uint8."""
    cb, cr = cb - 128, cr - 128
    r = y + ((91881 * cr + 32768) >> 16)
    g = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)


def ycc_to_rgb(planes: torch.Tensor, layout: torch.Tensor, out_bytes: int) -> torch.Tensor:
    """The batch's pixels, a flat uint8 tensor of ``out_bytes`` on
    ``planes``' device: each image of ``layout`` upsampled and converted as
    libjpeg does (gray images copied)."""
    rows = check_layout(layout, planes.numel(), out_bytes)
    out = torch.zeros(out_bytes, dtype=torch.uint8, device=planes.device)
    for y_off, cb_off, cr_off, cw, ch, h, w, kind, out_off in rows.tolist():
        y = planes[y_off:y_off + h * w]
        if kind == KIND_GRAY:
            out[out_off:out_off + h * w] = y
            continue
        cb = _upsample(planes[cb_off:cb_off + ch * cw].view(ch, cw), kind, h, w)
        cr = _upsample(planes[cr_off:cr_off + ch * cw].view(ch, cw), kind, h, w)
        rgb = _convert(y.view(h, w).to(torch.int32), cb, cr)
        out[out_off:out_off + h * w * 3] = rgb.reshape(-1)
    return out
