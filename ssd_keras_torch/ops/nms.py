"""Exact greedy NMS keep mask in plain PyTorch — the CUDA kernel's reference.

Port of ``ssd_keras_tpu/ops/nms.py:greedy_nms_mask`` (the scan form), with
the lane axis written out instead of ``vmap``. It runs on any device and is
what ``kernels/nms.py`` takes for CPU tensors; on the card it is the oracle
the kernel must equal bit for bit.

Bit-exactness contract (shared with ``csrc/nms.cu``): every step is one f32
elementwise op in the order ``iw``, ``ih``, ``inter = iw*ih``,
``union = area_i + area_j - inter``, ``iou = union > 0 ? inter/union : 0``,
then the strict ``iou > thr`` test against the threshold rounded to f32.

Beside it, the kernel's two passes in plain PyTorch with the kernel's data
layout, for the tests and ``chip_smoke.py`` (nothing on the main path calls
them): ``iou_suppression_mask`` (pass A) packs the IoU tests into
``(L, K, ceil(K / 64))`` int64 words, bit ``j % 64`` of word ``j // 64`` of
row ``i`` set iff ``i < j < bound`` and ``IoU(i, j) > thr``, where a lane's
``bound`` is one past its last valid row; ``greedy_keep_from_mask`` (pass
B) resolves the words chunk by chunk of 64 rows.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pairwise_iou_corners", "greedy_nms_mask", "select_top_candidates",
           "iou_suppression_mask", "greedy_keep_from_mask", "lane_bounds", "mask_words",
           "words_read"]

_WORD = 64
# Bit b of an int64 word as a Python int; bit 63 is the sign bit.
_BITS = [1 << b for b in range(_WORD - 1)] + [-(1 << (_WORD - 1))]


def mask_words(k: int) -> int:
    """Words of 64 bits in a row of the suppression mask of K candidates."""
    return (k + _WORD - 1) // _WORD


def lane_bounds(valid: torch.Tensor) -> torch.Tensor:
    """(L,) int64: one past each lane's last valid row (0 for an empty lane)."""
    lanes, k = valid.shape
    if k == 0:
        return torch.zeros(lanes, dtype=torch.int64, device=valid.device)
    rows = torch.arange(1, k + 1, device=valid.device)
    return torch.where(valid, rows, 0).amax(dim=1)


def words_read(valid: torch.Tensor) -> torch.Tensor:
    """(L, K, W) bool: the words pass B may read, and so pass A writes: rows
    below the lane's bound, words from the row's own chunk of 64 rows up to
    the bound's chunk."""
    lanes, k = valid.shape
    bound = lane_bounds(valid)[:, None, None]
    rows = torch.arange(k, device=valid.device)[None, :, None]
    word = torch.arange(mask_words(k), device=valid.device)[None, None, :]
    return (rows < bound) & (word >= rows // _WORD) & (word < (bound + _WORD - 1) // _WORD)


def _iou(ax1, ay1, ax2, ay2, a_area, bx1, by1, bx2, by2, b_area, d):
    """IoU of a against b in the contract's op order (shapes broadcast)."""
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + d).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + d).clamp_min(0.0)
    inter = iw * ih
    union = a_area + b_area - inter
    positive = union > 0  # a safe denominator: finite gradients at zero-area pairs
    return torch.where(positive, inter / torch.where(positive, union, 1.0), 0.0)


def _corners_and_area(boxes: torch.Tensor, d: float):
    x1, y1, x2, y2 = boxes.unbind(-1)
    return x1, y1, x2, y2, (x2 - x1 + d) * (y2 - y1 + d)


def pairwise_iou_corners(boxes: torch.Tensor, border_delta: float = 0.0) -> torch.Tensor:
    """(K, K) IoU of every pair of (K, 4) corner boxes, 0 where the union is
    not positive (``ssd_keras_tpu/ops/nms.py:pairwise_iou_corners``).
    ``border_delta`` is the reference's ``border_pixels`` convention ('half'
    0, 'include' +1, 'exclude' -1). The gradient is finite at zero-area
    pairs too."""
    corners = _corners_and_area(boxes, border_delta)
    return _iou(*(c[:, None] for c in corners), *(c[None, :] for c in corners), border_delta)


def select_top_candidates(scores: torch.Tensor, boxes: torch.Tensor, k: int):
    """The ``k`` highest of (N,) ``scores`` with their (N, 4) ``boxes``:
    ``(top_scores, boxes[idx], idx)``. Equal scores keep the lower index
    first, as ``jax.lax.top_k`` does (a stable descending sort)."""
    top_scores, idx = torch.sort(scores, descending=True, stable=True)
    top_scores, idx = top_scores[:k], idx[:k]
    return top_scores, boxes[idx], idx


def greedy_nms_mask(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    border_delta: float = 0.0,
) -> torch.Tensor:
    """Greedy NMS over L independent lanes of score-descending candidates.

    Args:
      boxes: (L, K, 4) f32 corners (xmin, ymin, xmax, ymax), each lane sorted
        by score descending.
      valid: (L, K) bool, candidates eligible for selection.
      iou_threshold: a candidate whose IoU with an already-kept one is
        *strictly greater* than this is suppressed.
      border_delta: the ``border_pixels`` width offset (0, +1 or -1).

    Returns:
      (L, K) bool keep mask:
      ``keep[i] = valid[i] and not any(keep[j] and iou(j, i) > thr, j < i)``.

    Rows after the last valid row of every lane can neither be kept nor
    suppress anything, so the loop stops there (the kernel's trip bound).
    """
    thr = float(np.float32(iou_threshold))
    d = float(border_delta)
    x1, y1, x2, y2, area = _corners_and_area(boxes, d)
    keep = torch.zeros_like(valid)
    suppressed = torch.zeros_like(valid)
    bound = int(lane_bounds(valid).max()) if valid.numel() else 0
    for i in range(bound):
        keep_i = valid[:, i] & ~suppressed[:, i]
        keep[:, i] = keep_i
        j = slice(i + 1, bound)  # only later rows can be suppressed by row i
        a = slice(i, i + 1)
        iou = _iou(x1[:, a], y1[:, a], x2[:, a], y2[:, a], area[:, a],
                   x1[:, j], y1[:, j], x2[:, j], y2[:, j], area[:, j], d)
        suppressed[:, j] |= keep_i[:, None] & (iou > thr)
    return keep


def iou_suppression_mask(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    border_delta: float = 0.0,
) -> torch.Tensor:
    """The kernel's pass A: (L, K, ceil(K / 64)) int64 words, bit ``j % 64``
    of word ``j // 64`` of row ``i`` set iff ``i < j < bound`` and
    ``IoU(i, j) > thr`` (row ``i`` as "a"). Every other bit is 0, so are the
    words below the diagonal and past the bound."""
    lanes, k = valid.shape
    thr = float(np.float32(iou_threshold))
    d = float(border_delta)
    x1, y1, x2, y2, area = _corners_and_area(boxes, d)
    bound = lane_bounds(valid)
    rows = torch.arange(k, device=valid.device)
    mask = torch.zeros(lanes, k, mask_words(k), dtype=torch.int64, device=valid.device)
    for c in range(mask_words(k)):
        j = slice(c * _WORD, min((c + 1) * _WORD, k))
        iou = _iou(x1[:, :, None], y1[:, :, None], x2[:, :, None], y2[:, :, None],
                   area[:, :, None], x1[:, None, j], y1[:, None, j], x2[:, None, j],
                   y2[:, None, j], area[:, None, j], d)  # (L, K, <= 64)
        hit = ((iou > thr) & (rows[None, None, j] > rows[None, :, None])
               & (rows[None, None, j] < bound[:, None, None]))
        word = mask[:, :, c]
        for b in range(hit.shape[2]):
            word |= torch.where(hit[..., b], _BITS[b], 0)
    return mask


def greedy_keep_from_mask(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The kernel's pass B: the (L, K) bool keep mask from pass A's words.

    Walks each lane's rows below its bound in chunks of 64: a row is kept
    iff valid and its bit in the chunk's removed word is clear, and a kept
    row ORs its diagonal word into that word (row by row here; the kernel
    reaches the same bits as a fixpoint over the chunk); then the chunk's
    kept rows OR their words of every later chunk below the bound into the
    removed bitmap. Reads only the words pass A writes, so a mask whose
    other words hold anything gives the same result."""
    lanes, k = valid.shape
    bound = lane_bounds(valid)
    words = (bound + _WORD - 1) // _WORD
    removed = torch.zeros(lanes, mask_words(k), dtype=torch.int64, device=valid.device)
    keep = torch.zeros_like(valid)
    for c in range(mask_words(k)):
        for r in range(c * _WORD, min((c + 1) * _WORD, k)):
            bit = _BITS[r - c * _WORD]
            cand = valid[:, r] & (r < bound) & ((removed[:, c] & bit) == 0)
            keep[:, r] = cand
            removed[:, c] |= torch.where(cand, mask[:, r, c], 0)
        later = torch.arange(c + 1, mask_words(k), device=valid.device)
        below = later[None, :] < words[:, None]  # (L, later words)
        for r in range(c * _WORD, min((c + 1) * _WORD, k)):
            removed[:, c + 1:] |= torch.where(
                keep[:, r, None] & below, mask[:, r, c + 1:], 0)
    return keep
