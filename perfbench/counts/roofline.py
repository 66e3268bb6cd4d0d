"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit) and the least time the port's two hand-written kernels
could take for the work a set of inputs needs."""

from __future__ import annotations

import numpy as np

BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

# Greedy NMS (csrc/nms.cu): one IoU and its compare a pair of a kept row
# and a later row of its lane: 2 min, 2 max, 4 add/sub, 2 clamps, the
# product, the union's add and sub, the division, 2 compares.
NMS_OPS_PER_PAIR = 16


def nms_bound(valid: np.ndarray, keep: np.ndarray) -> dict:
    """The work of one NMS call over lanes (L, K) of score-sorted
    candidates: each kept row against the rows after it up to its lane's
    last valid row; the valid rows' boxes (16 bytes) and every valid flag
    read once, the keep flags written once."""
    valid, keep = np.asarray(valid, bool), np.asarray(keep, bool)
    k = valid.shape[1]
    rows = np.arange(1, k + 1)
    bound = np.where(valid, rows, 0).max(axis=1)  # one past the last valid row
    after = bound[:, None] - rows[None, :]
    pairs = int(np.where(keep, after, 0).sum())
    nbytes = 16 * int(valid.sum()) + valid.size + keep.size
    ops_s, bytes_s = pairs * NMS_OPS_PER_PAIR / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return dict(pairs=pairs, bytes=nbytes, seconds=max(ops_s, bytes_s),
                bound_by="operations" if ops_s >= bytes_s else "bytes")


# A JPEG's row of the colour kernel's layout: nine int64 fields.
JPEG_LAYOUT_BYTES = 9 * 8


def jpeg_color_bytes(height: int, width: int, subsampling: str = "4:2:0") -> int:
    """The bytes the colour kernel needs for one colour JPEG: its Y, Cb and
    Cr planes read once, its RGB pixels written once, its layout row."""
    ch, cw = {"4:2:0": (-(-height // 2), -(-width // 2)), "4:2:2": (height, -(-width // 2)),
              "4:4:4": (height, width)}[subsampling]
    return height * width + 2 * ch * cw + 3 * height * width + JPEG_LAYOUT_BYTES


def jpeg_color_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
