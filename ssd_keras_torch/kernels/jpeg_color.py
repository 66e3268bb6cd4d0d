"""libjpeg's chroma upsampling and YCbCr -> RGB conversion: the CUDA kernel
``csrc/jpeg_color.cu`` and its wrapper.

The card's JPEG decoder (``native/jpeg.py``) has nvJPEG decode a batch to
its planes and hands them here, so that the pixels are libjpeg's (PIL's,
the JAX package's) up to nvJPEG's IDCT, which is within a level of
libjpeg's. Not the port of a TPU kernel: the JAX package runs this stage
inside libjpeg on its host (``ssd_keras_tpu/native/ssd_jpeg.cpp``).

What bounds it on the card: the bytes (each plane read once, the pixels
written once). One launch a batch, one block a tile: ``bands`` cuts each
image into tiles of whole rows (an even number, so that a 4:2:0 tile holds
whole chroma rows) and at most ``TILE_COLS`` columns, about
``TILE_PIXELS`` pixels each; the tiles' table goes up with the layout.

Dispatch is by the tensors' device and nothing else: CPU tensors go to the
plain PyTorch version (``ops/jpeg_color.py:ycc_to_rgb``); CUDA tensors
launch the kernel or raise. The counter ``jpeg_color.launches``
(``utils.profiling.count``) counts the calls that launched it.
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_keras_torch.kernels import build
from ssd_keras_torch.ops import jpeg_color
from ssd_keras_torch.utils.profiling import count

__all__ = ["ycc_to_rgb", "bands", "tile_shape", "tile_table", "launch"]

# The kernel's tile plan (``csrc/jpeg_color.cu`` holds the same constants,
# and sizes its shared staging for the largest tile they allow).
TILE_COLS = 512
TILE_PIXELS = 2048
TILE_ROWS_MAX = 32
# A tile's table entry: image, first row, first column, rows (int32).
BAND_FIELDS = 4


def tile_shape(width: int):
    """(rows, columns) of the tiles of an image ``width`` wide (its last
    tile in each direction may be smaller)."""
    cols = min(width, TILE_COLS)
    return min(TILE_ROWS_MAX, (TILE_PIXELS // cols) & ~1), cols


def bands(rows: np.ndarray) -> np.ndarray:
    """The kernel's tiles for the images of a checked layout ``rows``: an
    int32 (tiles, 4) array of (image, first row, first column, rows), the
    tiles of each image in row-major order, covering every pixel once."""
    heights, widths = rows[:, 5], rows[:, 6]
    shapes = np.array([tile_shape(int(w)) for w in widths], dtype=np.int64).reshape(-1, 2)
    tile_rows, tile_cols = shapes[:, 0], shapes[:, 1]
    down = -(-heights // tile_rows)
    across = -(-widths // tile_cols)
    counts = down * across
    image = np.repeat(np.arange(len(rows)), counts)
    local = np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts) - counts, counts)
    row0 = local // across[image] * tile_rows[image]
    col0 = local % across[image] * tile_cols[image]
    n_rows = np.minimum(tile_rows[image], heights[image] - row0)
    return np.stack([image, row0, col0, n_rows], 1).astype(np.int32)


def tile_table(rows: np.ndarray):
    """What the kernel reads besides the planes, as one int64 array for one
    upload: the layout's rows, then the tiles' int32 entries (``bands``).
    Returns (table, number of tiles)."""
    tiles = bands(rows)
    if len(tiles) >= 2 ** 31:
        raise ValueError(f"{len(tiles)} tiles exceed the kernel's grid")
    table = np.empty(rows.size + tiles.size // 2, dtype=np.int64)
    table[:rows.size] = rows.reshape(-1)
    table[rows.size:].view(np.int32)[:] = tiles.reshape(-1)
    return table, len(tiles)


def launch(planes: torch.Tensor, table: torch.Tensor, n_images: int, n_tiles: int,
           out: torch.Tensor) -> None:
    """One launch of the kernel on the current stream, counted in
    ``jpeg_color.launches``: ``table`` (``tile_table``'s array, on ``planes``' card)
    for ``n_images`` layout rows and ``n_tiles`` tiles, the pixels into
    ``out``. The caller checks the layout (``ycc_to_rgb`` does); raises
    ``ValueError`` on a table or output of another size, type or device."""
    if (table.dtype != torch.int64 or table.device != planes.device or not table.is_contiguous()
            or table.numel() != n_images * len(jpeg_color.LAYOUT_FIELDS) + n_tiles * 2):
        raise ValueError(f"table: {table.dtype} {tuple(table.shape)} on {table.device} is not "
                         f"the table of {n_images} images and {n_tiles} tiles on {planes.device}")
    if out.dtype != torch.uint8 or out.device != planes.device or not out.is_contiguous():
        raise ValueError(f"out: {out.dtype} on {out.device}, not uint8 on {planes.device}")
    build.launch("ssd_jpeg_ycc_to_rgb", planes.device, planes.data_ptr(), planes.numel(),
                 table.data_ptr(), table.data_ptr() + 8 * n_images * len(jpeg_color.LAYOUT_FIELDS),
                 out.data_ptr(), n_tiles)
    count("jpeg_color.launches")


def ycc_to_rgb(planes: torch.Tensor, layout: torch.Tensor, out_bytes: int) -> torch.Tensor:
    """The batch's pixels, a flat uint8 tensor of ``out_bytes`` on
    ``planes``' device (see ``ops/jpeg_color.py`` for ``layout``, a CPU
    int64 (n, 9) tensor). On the card: one kernel launch on the current
    stream, counted in ``jpeg_color.launches``; the layout and the tiles' table go up
    together from pinned memory without a wait."""
    if planes.dtype != torch.uint8 or planes.dim() != 1 or not planes.is_contiguous():
        raise ValueError(f"planes must be a contiguous 1-D uint8 tensor, got {planes.dtype} "
                         f"{tuple(planes.shape)}")
    if planes.device.type == "cpu":
        return jpeg_color.ycc_to_rgb(planes, layout, out_bytes)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    rows = jpeg_color.check_layout(layout, planes.numel(), out_bytes)
    out = torch.empty(out_bytes, dtype=torch.uint8, device=planes.device)
    if len(rows) == 0:
        return out
    table, n_tiles = tile_table(rows)
    device_table = torch.from_numpy(table).pin_memory().to(planes.device, non_blocking=True)
    launch(planes, device_table, len(rows), n_tiles, out)
    return out
