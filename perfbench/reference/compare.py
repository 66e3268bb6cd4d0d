"""The numbers that judge a program's detections of one image against the
reference's.

A detection is a score for a class and a box. Two gaps, in units of score:

``served_gap``: how far a detection the program returned scores above the
reference's best support for it: the highest score the reference gives
its class among all of the image's boxes that overlap it by an IoU of
``support_iou`` or more. A detection the reference does not support at all
has the gap of its whole score.

``missed_gap``: how far a detection the reference returns scores above the
program's best detection of its class that overlaps it by ``match_iou`` or
more, but never more than the detection's ``margin``: how far it stands
above the nearest cut of the decode (threshold, compaction, candidate pool,
``top_k``) that a small change of score could move it past. Greedy NMS
keeps one of two boxes that overlap by more than its IoU threshold, and
which one can turn on a rounding, so ``match_iou`` sits below that
threshold.

Either gap is 0 where the two agree to the score.
"""

from __future__ import annotations

import torch

from perfbench.reference.decode import pairwise_iou


def gaps(served: torch.Tensor, ref_scores: torch.Tensor, ref_corners: torch.Tensor,
         ref_detections: torch.Tensor, ref_margin: torch.Tensor, support_iou: float = 0.5,
         match_iou: float = 0.4):
    """``served`` (n, 6) and ``ref_detections`` (m, 6): [class, score, x1,
    y1, x2, y2] in the image's frame, no zero rows, and ``ref_margin`` (m,)
    each reference detection's margin; ``ref_scores`` (N, C) and
    ``ref_corners`` (N, 4): the reference's every box in that frame.
    Returns (served_gap, missed_gap)."""
    served_gap = 0.0
    if len(served):
        iou = pairwise_iou(served[:, 2:6], ref_corners)  # (n, N)
        per_box = ref_scores[:, served[:, 0].long()].T  # (n, N): each detection's class
        support = torch.where(iou >= support_iou, per_box, torch.zeros_like(per_box)).amax(1)
        served_gap = float((served[:, 1] - support).clamp_min(0).max())
    missed_gap = 0.0
    if len(ref_detections):
        best = torch.zeros(len(ref_detections), device=ref_detections.device)
        if len(served):
            iou = pairwise_iou(ref_detections[:, 2:6], served[:, 2:6])  # (m, n)
            same = ref_detections[:, None, 0] == served[None, :, 0]
            best = torch.where(same & (iou >= match_iou), served[None, :, 1],
                               torch.zeros_like(iou)).amax(1)
        missed = torch.minimum(ref_detections[:, 1] - best, ref_margin)
        missed_gap = float(missed.clamp_min(0).max())
    return served_gap, missed_gap
