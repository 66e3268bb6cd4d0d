"""Exact greedy NMS keep mask in plain PyTorch — the CUDA kernel's reference.

Port of ``ssd_keras_tpu/ops/nms.py:greedy_nms_mask`` (the scan form), with
the lane axis written out instead of ``vmap``. It runs on any device and is
what ``kernels/nms.py`` takes for CPU tensors; on the card it is the oracle
the kernel must equal bit for bit.

Bit-exactness contract (shared with ``csrc/nms.cu``): every step is one f32
elementwise op in the order ``iw``, ``ih``, ``inter = iw*ih``,
``union = area_i + area_j - inter``, ``iou = union > 0 ? inter/union : 0``,
then the strict ``iou > thr`` test against the threshold rounded to f32.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["greedy_nms_mask"]


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
    _, k = valid.shape
    thr = float(np.float32(iou_threshold))
    d = float(border_delta)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + d) * (y2 - y1 + d)
    keep = torch.zeros_like(valid)
    suppressed = torch.zeros_like(valid)
    rows = torch.arange(1, k + 1, device=valid.device)
    bound = int(torch.where(valid, rows, 0).max()) if valid.numel() else 0
    for i in range(bound):
        keep_i = valid[:, i] & ~suppressed[:, i]
        keep[:, i] = keep_i
        j = slice(i + 1, bound)  # only later rows can be suppressed by row i
        iw = (torch.minimum(x2[:, i : i + 1], x2[:, j])
              - torch.maximum(x1[:, i : i + 1], x1[:, j]) + d).clamp_min(0.0)
        ih = (torch.minimum(y2[:, i : i + 1], y2[:, j])
              - torch.maximum(y1[:, i : i + 1], y1[:, j]) + d).clamp_min(0.0)
        inter = iw * ih
        union = area[:, i : i + 1] + area[:, j] - inter
        iou = torch.where(union > 0, inter / union, 0.0)
        suppressed[:, j] |= keep_i[:, None] & (iou > thr)
    return keep
