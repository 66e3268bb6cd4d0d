"""Pascal VOC's mean average precision as ssd_keras's ``Evaluator`` computes
it, in NumPy: per class, detections in descending score
(``np.argsort(-score, kind='quicksort')`` on float32 scores, so ties fall as
there), each matched to its image's ground-truth box of the class with
the highest IoU; a match of ``iou_threshold`` or more to an unclaimed box
is a true positive, to a claimed one a false positive, to a "difficult"
box neither; precision and recall cumulate; AP is the mean over 11 recall
points of the highest precision at that recall or more. The IoU is
ssd_keras's: the intersection of the plain corners, the areas with
``border`` (1 for 'include') added to widths and heights.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _iou(gt: np.ndarray, box: np.ndarray, border: float) -> np.ndarray:
    iw = np.maximum(0, np.minimum(gt[:, 2], box[2]) - np.maximum(gt[:, 0], box[0]))
    ih = np.maximum(0, np.minimum(gt[:, 3], box[3]) - np.maximum(gt[:, 1], box[1]))
    inter = iw * ih
    a = (gt[:, 2] - gt[:, 0] + border) * (gt[:, 3] - gt[:, 1] + border)
    b = (box[2] - box[0] + border) * (box[3] - box[1] + border)
    return inter / (a + b - inter)


def mean_average_precision(results: Sequence[Sequence[tuple]], labels, difficult, image_ids,
                           n_classes: int, iou_threshold: float = 0.5, border: float = 1.0,
                           recall_points: int = 11) -> float:
    """``results[c]``: (image_id, score, x1, y1, x2, y2) of class c;
    ``labels[i]``: (k, 5) [class, x1, y1, x2, y2]; ``difficult[i]``: k
    flags."""
    row = {str(image_id): i for i, image_id in enumerate(image_ids)}
    aps = []
    for c in range(1, n_classes + 1):
        n_gt = sum(int(((np.asarray(lab)[:, 0] == c) & ~np.asarray(dif, bool)).sum())
                   for lab, dif in zip(labels, difficult) if len(lab))
        preds = results[c]
        if not len(preds):
            aps.append(0.0)
            continue
        scores = np.array([p[1] for p in preds], dtype=np.float32)
        order = np.argsort(-scores, kind="quicksort")
        tp = np.zeros(len(preds), np.int64)
        fp = np.zeros(len(preds), np.int64)
        claimed = {}
        for rank, idx in enumerate(order):
            i = row[str(preds[idx][0])]
            lab = np.asarray(labels[i])
            if not lab.size:
                fp[rank] = 1
                continue
            mask = lab[:, 0] == c
            gt = lab[mask]
            if not gt.size:
                fp[rank] = 1
                continue
            box = np.asarray(preds[idx][2:6], np.float32)
            iou = _iou(gt[:, 1:5].astype(np.float32), box, border)
            j = int(np.argmax(iou))
            if iou[j] < iou_threshold:
                fp[rank] = 1
                continue
            if bool(np.asarray(difficult[i], bool)[mask][j]):
                continue
            got = claimed.setdefault(i, np.zeros(len(gt), bool))
            if got[j]:
                fp[rank] = 1
            else:
                tp[rank] = 1
                got[j] = True
        ctp, cfp = np.cumsum(tp).astype(np.float64), np.cumsum(fp).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = np.where(ctp + cfp > 0, ctp / (ctp + cfp), 0)
        recall = ctp / n_gt if n_gt > 0 else np.zeros_like(ctp)
        ap = 0.0
        for t in np.linspace(0, 1, recall_points, endpoint=True):
            eligible = precision[recall >= t]
            ap += float(np.amax(eligible)) if eligible.size else 0.0
        aps.append(ap / recall_points)
    return float(np.average(aps))
