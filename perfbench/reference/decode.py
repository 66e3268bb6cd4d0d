"""The Caffe SSD decode (``DetectionOutput``) as ssd_keras's
``DecodeDetections`` layer sets it, in plain PyTorch.

For each image: the boxes are compacted to the ``compact`` boxes with the
highest non-background score when there are more (ssd_keras_tpu's
compaction, which the port keeps); each class keeps the scores above the
threshold (strict), its top ``nms_max_output_size`` of them, and greedy
NMS (a box goes when its IoU with a kept, higher-scoring box exceeds the
threshold; ``border`` is added to widths and heights); then the image keeps
its ``top_k`` best detections over all classes, ties in the order of the
classes and their candidates.
"""

from __future__ import annotations

from typing import Dict

import torch


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, border: float = 0.0) -> torch.Tensor:
    """IoU of corner boxes a (..., n, 4) against b (..., m, 4): (..., n, m)."""
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (x2 - x1 + border).clamp_min(0) * (y2 - y1 + border).clamp_min(0)
    area_a = (a[..., 2] - a[..., 0] + border) * (a[..., 3] - a[..., 1] + border)
    area_b = (b[..., 2] - b[..., 0] + border) * (b[..., 3] - b[..., 1] + border)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.where(union > 0, union, torch.ones_like(union))


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
               border: float = 0.0) -> torch.Tensor:
    """Keep mask (L, K) of lanes of score-sorted boxes (L, K, 4): each row
    in order is kept unless a kept row before it overlaps it above the
    threshold."""
    lanes, k = valid.shape
    over = pairwise_iou(boxes, boxes, border) > iou_threshold  # (L, K, K)
    keep = valid.clone()
    after = torch.arange(k, device=boxes.device)
    for i in range(k):
        hit = keep[:, i, None] & over[:, i, :] & (after > i)[None]
        keep &= ~hit
    return keep


def decode(scores: torch.Tensor, corners: torch.Tensor, confidence_thresh: float,
           iou_threshold: float, top_k: int, nms_max_output_size: int, compact: int = 512,
           border: float = 0.0) -> Dict[str, torch.Tensor]:
    """Detections (B, top_k, 6) as [class, score, x1, y1, x2, y2], zero rows
    at the end, from scores (B, N, C) and corners (B, N, 4); the NMS lanes'
    valid and keep masks (B * (C - 1), K); and each detection's ``margin``
    (B, top_k): how far it stands above the nearest cut that could have
    left it out (the threshold; the best box the compaction dropped, by the
    largest class score; its class's best candidate past the
    ``nms_max_output_size``; the image's best detection past the
    ``top_k``)."""
    b, n, c = scores.shape
    inf = torch.tensor(float("inf"), device=scores.device)
    cls = scores[:, :, 1:]
    best = cls.amax(-1)
    compact_cut = -inf.expand(b, 1)
    if compact and n > compact:
        best, order = torch.sort(best, dim=-1, descending=True, stable=True)
        compact_cut = best[:, compact, None]
        best, order = best[:, :compact], order[:, :compact]
        cls = torch.gather(cls, 1, order[..., None].expand(-1, -1, c - 1))
        corners = torch.gather(corners, 1, order[..., None].expand(-1, -1, 4))
    lanes = cls.transpose(1, 2)  # (B, C-1, M)
    thresh = float(torch.tensor(confidence_thresh, dtype=torch.float32))
    m = lanes.shape[-1]
    k = min(nms_max_output_size, m)
    masked = torch.where(lanes > thresh, lanes, torch.full_like(lanes, -1.0))
    ranked, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    lane_cut = torch.full(ranked.shape[:2], thresh, device=scores.device)
    if m > k:
        lane_cut = torch.maximum(lane_cut, ranked[..., k])
    cand, idx = ranked[..., :k], idx[..., :k]
    boxes = torch.gather(corners[:, None].expand(-1, c - 1, -1, -1), 2,
                         idx[..., None].expand(-1, -1, -1, 4))
    margin = torch.minimum(torch.gather(best[:, None].expand(-1, c - 1, -1), 2, idx)
                           - compact_cut[:, :, None], cand - lane_cut[..., None])
    valid = cand > thresh
    keep = greedy_nms(boxes.reshape(-1, k, 4), valid.reshape(-1, k), iou_threshold,
                      border).reshape(valid.shape)
    kept = torch.where(keep, cand, torch.zeros_like(cand)).reshape(b, -1)
    classes = torch.arange(1, c, device=scores.device, dtype=scores.dtype)
    classes = classes[None, :, None].expand(b, -1, k).reshape(b, -1)
    ranked, order = torch.sort(kept, dim=-1, descending=True, stable=True)
    n_top = min(top_k, kept.shape[1])
    top, order = ranked[:, :n_top], order[:, :n_top]
    global_cut = (ranked[:, n_top, None] if kept.shape[1] > n_top
                  else torch.zeros_like(top[:, :1]))
    rows = torch.cat([torch.gather(classes, 1, order)[..., None], top[..., None],
                      torch.gather(boxes.reshape(b, -1, 4), 1,
                                   order[..., None].expand(-1, -1, 4))], -1)
    margin = torch.minimum(torch.gather(margin.reshape(b, -1), 1, order), top - global_cut)
    real = top > 0
    rows = torch.where(real[..., None], rows, torch.zeros_like(rows))
    margin = torch.where(real, margin, torch.zeros_like(margin))
    if n_top < top_k:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, top_k - n_top))
        margin = torch.nn.functional.pad(margin, (0, top_k - n_top))
    return dict(detections=rows, margin=margin, valid=valid.reshape(-1, k),
                keep=keep.reshape(-1, k))
