"""Minimal self-contained COCO bbox evaluation (the standard 12 metrics).

pycocotools is not available in every environment, but the COCO workflow
(ssd300_evaluation_COCO.ipynb cells 13-16) ends with an
executed ``COCOeval`` — this module implements the same published protocol
in plain NumPy so ``predict_all_to_json``'s output can be *scored*, not just
schema-checked: per-(image, category) greedy matching at 10 IoU thresholds,
crowd/area/maxDet ignore rules, 101-point interpolated precision, and the
standard AP/AP50/AP75/APsmall..large/AR1..100 summary.

The protocol (matching order, ignore semantics, interpolation) follows the
public COCO evaluation specification; the implementation is original.
Differences from pycocotools are covered by tests with analytically known
AP values (tests/test_cocoeval.py).

Vendored from ``ssd_keras_tpu/eval/cocoeval.py`` (NumPy only) with only the import
paths changed, so that the PyTorch port imports without JAX.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["COCOEvalBBox", "coco_bbox_iou"]

# The standard COCO parameterization.
_IOU_THRS = np.linspace(0.5, 0.95, 10)
_REC_THRS = np.linspace(0.0, 1.0, 101)
_MAX_DETS = (1, 10, 100)
_AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
_AREA_ORDER = ("all", "small", "medium", "large")

METRIC_NAMES = (
    "AP", "AP50", "AP75", "APsmall", "APmedium", "APlarge",
    "AR1", "AR10", "AR100", "ARsmall", "ARmedium", "ARlarge",
)


def coco_bbox_iou(
    dt: np.ndarray, gt: np.ndarray, iscrowd: Optional[np.ndarray] = None
) -> np.ndarray:
    """IoU matrix between ``(D, 4)`` and ``(G, 4)`` xywh boxes.

    Crowd ground truths use the COCO convention: the "union" is just the
    detection's area (a detection fully inside a crowd region scores 1).
    """
    dt = np.asarray(dt, dtype=np.float64).reshape(-1, 4)
    gt = np.asarray(gt, dtype=np.float64).reshape(-1, 4)
    d_area = dt[:, 2] * dt[:, 3]
    g_area = gt[:, 2] * gt[:, 3]
    lx = np.maximum(dt[:, None, 0], gt[None, :, 0])
    ly = np.maximum(dt[:, None, 1], gt[None, :, 1])
    hx = np.minimum(dt[:, None, 0] + dt[:, None, 2], gt[None, :, 0] + gt[None, :, 2])
    hy = np.minimum(dt[:, None, 1] + dt[:, None, 3], gt[None, :, 1] + gt[None, :, 3])
    inter = np.clip(hx - lx, 0, None) * np.clip(hy - ly, 0, None)
    union = d_area[:, None] + g_area[None, :] - inter
    if iscrowd is not None:
        crowd = np.asarray(iscrowd, dtype=bool)
        union = np.where(crowd[None, :], d_area[:, None], union)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


class COCOEvalBBox:
    """Evaluate COCO-format bbox detections against COCO-format ground truth.

    ``gt``: a COCO annotations dict (or path to one) with 'images',
    'annotations' (bbox xywh, category_id, image_id, optional area/iscrowd/
    ignore) and 'categories'. ``results``: a COCO results list (or path) of
    {image_id, category_id, bbox xywh, score} — exactly what
    :func:`ssd_keras_torch.eval.coco.predict_all_to_json` writes.
    """

    def __init__(
        self,
        gt: Union[str, Dict],
        results: Union[str, Sequence[Dict]],
        max_dets: Sequence[int] = _MAX_DETS,
    ):
        if isinstance(gt, str):
            with open(gt) as f:
                gt = json.load(f)
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        self.max_dets = tuple(max_dets)
        self.img_ids = [img["id"] for img in gt.get("images", [])]
        self.cat_ids = sorted(c["id"] for c in gt.get("categories", []))
        if not self.img_ids:  # tolerate GT dicts listing only annotations
            self.img_ids = sorted({a["image_id"] for a in gt["annotations"]})

        self._gts: Dict[Tuple, List[Dict]] = {}
        for ann in gt.get("annotations", []):
            key = (ann["image_id"], ann["category_id"])
            a = dict(ann)
            if "area" not in a:
                a["area"] = float(a["bbox"][2]) * float(a["bbox"][3])
            a["iscrowd"] = int(a.get("iscrowd", 0))
            a["_forced_ignore"] = bool(a.get("ignore", 0)) or a["iscrowd"] == 1
            self._gts.setdefault(key, []).append(a)
        self._dts: Dict[Tuple, List[Dict]] = {}
        for det in results:
            key = (det["image_id"], det["category_id"])
            self._dts.setdefault(key, []).append(det)

        self.stats: Optional[np.ndarray] = None
        self.metrics: Optional[Dict[str, float]] = None

    # ------------------------------------------------------------------ #

    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        """Match one (image, category) pair at every IoU threshold.

        Returns None when there is nothing to match, else a dict of
        per-detection match/ignore flags and per-gt ignore flags.
        """
        gts = self._gts.get((img_id, cat_id), [])
        dts = self._dts.get((img_id, cat_id), [])
        if not gts and not dts:
            return None

        g_ignore = np.array(
            [
                g["_forced_ignore"]
                or g["area"] < area_rng[0]
                or g["area"] > area_rng[1]
                for g in gts
            ],
            dtype=bool,
        )
        # Ignored gts match last: stable-sort them to the back.
        g_order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        g_crowd = np.array([g["iscrowd"] == 1 for g in gts], dtype=bool)

        scores = np.array([d["score"] for d in dts], dtype=np.float64)
        d_order = np.argsort(-scores, kind="stable")[:max_det]
        dts = [dts[i] for i in d_order]
        scores = scores[d_order]

        T, D, G = len(_IOU_THRS), len(dts), len(gts)
        d_match = np.zeros((T, D), dtype=np.int64)  # 1 + matched gt index
        g_match = np.zeros((T, G), dtype=np.int64)
        d_ignore = np.zeros((T, D), dtype=bool)
        if D and G:
            ious = coco_bbox_iou(
                np.array([d["bbox"] for d in dts]),
                np.array([g["bbox"] for g in gts]),
                iscrowd=g_crowd,
            )
            for t, thr in enumerate(_IOU_THRS):
                for d in range(D):
                    best = min(thr, 1.0 - 1e-10)
                    m = -1
                    for g in range(G):
                        if g_match[t, g] and not g_crowd[g]:
                            continue  # taken, and crowds stay matchable
                        if m > -1 and not g_ignore[m] and g_ignore[g]:
                            break  # only ignored gts remain; keep real match
                        if ious[d, g] < best:
                            continue
                        best = ious[d, g]
                        m = g
                    if m == -1:
                        continue
                    d_match[t, d] = m + 1
                    g_match[t, m] = d + 1
                    d_ignore[t, d] = g_ignore[m]
        # Unmatched detections outside the area range don't count as FPs.
        d_area_out = np.array(
            [
                d["bbox"][2] * d["bbox"][3] < area_rng[0]
                or d["bbox"][2] * d["bbox"][3] > area_rng[1]
                for d in dts
            ],
            dtype=bool,
        )
        d_ignore |= (d_match == 0) & d_area_out[None, :]
        return {
            "scores": scores,
            "d_match": d_match,
            "d_ignore": d_ignore,
            "g_ignore": g_ignore,
        }

    # ------------------------------------------------------------------ #

    def evaluate(self) -> Dict[str, float]:
        """Run matching + accumulation; returns the 12 standard metrics."""
        T, R = len(_IOU_THRS), len(_REC_THRS)
        K, A, M = len(self.cat_ids), len(_AREA_ORDER), len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        max_det_cap = max(self.max_dets)

        for k, cat_id in enumerate(self.cat_ids):
            for a, area_name in enumerate(_AREA_ORDER):
                area_rng = _AREA_RNGS[area_name]
                per_img = [
                    self._evaluate_img(img_id, cat_id, area_rng, max_det_cap)
                    for img_id in self.img_ids
                ]
                per_img = [e for e in per_img if e is not None]
                if not per_img:
                    continue
                n_pos = int(sum((~e["g_ignore"]).sum() for e in per_img))
                for m, max_det in enumerate(self.max_dets):
                    scores = np.concatenate(
                        [e["scores"][:max_det] for e in per_img]
                    )
                    order = np.argsort(-scores, kind="stable")
                    dm = np.concatenate(
                        [e["d_match"][:, :max_det] for e in per_img], axis=1
                    )[:, order]
                    dig = np.concatenate(
                        [e["d_ignore"][:, :max_det] for e in per_img], axis=1
                    )[:, order]
                    if n_pos == 0:
                        continue
                    tps = np.cumsum((dm > 0) & ~dig, axis=1, dtype=np.float64)
                    fps = np.cumsum((dm == 0) & ~dig, axis=1, dtype=np.float64)
                    for t in range(T):
                        tp, fp = tps[t], fps[t]
                        nd = len(tp)
                        rc = tp / n_pos
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0.0
                        # Monotone-decreasing precision envelope, sampled at
                        # the 101 standard recall points.
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        q = np.zeros(R)
                        inds = np.searchsorted(rc, _REC_THRS, side="left")
                        valid = inds < nd
                        q[valid] = pr[inds[valid]]
                        precision[t, :, k, a, m] = q

        def _summary(use_ap, iou_thr=None, area="all", max_det=100):
            a = _AREA_ORDER.index(area)
            m = self.max_dets.index(max_det)
            if use_ap:
                s = precision[:, :, :, a, m]
                if iou_thr is not None:
                    s = s[np.isclose(_IOU_THRS, iou_thr)]
            else:
                s = recall[:, :, a, m]
                if iou_thr is not None:
                    s = s[np.isclose(_IOU_THRS, iou_thr)]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        stats = [
            _summary(True),
            _summary(True, iou_thr=0.5),
            _summary(True, iou_thr=0.75),
            _summary(True, area="small"),
            _summary(True, area="medium"),
            _summary(True, area="large"),
            _summary(False, max_det=self.max_dets[0]),
            _summary(False, max_det=self.max_dets[1]),
            _summary(False, max_det=self.max_dets[2]),
            _summary(False, area="small"),
            _summary(False, area="medium"),
            _summary(False, area="large"),
        ]
        self.stats = np.array(stats)
        self.metrics = dict(zip(METRIC_NAMES, stats))
        return self.metrics

    def summarize(self, print_fn=print) -> None:
        """Print the familiar 12-line COCO summary block."""
        if self.metrics is None:
            self.evaluate()
        tmpl = (
            " {:<18} @[ IoU={:<9} | area={:>6} | maxDets={:>3} ] = {:0.3f}"
        )
        rows = [
            ("Average Precision", "0.50:0.95", "all", self.max_dets[2], "AP"),
            ("Average Precision", "0.50", "all", self.max_dets[2], "AP50"),
            ("Average Precision", "0.75", "all", self.max_dets[2], "AP75"),
            ("Average Precision", "0.50:0.95", "small", self.max_dets[2], "APsmall"),
            ("Average Precision", "0.50:0.95", "medium", self.max_dets[2], "APmedium"),
            ("Average Precision", "0.50:0.95", "large", self.max_dets[2], "APlarge"),
            ("Average Recall", "0.50:0.95", "all", self.max_dets[0], "AR1"),
            ("Average Recall", "0.50:0.95", "all", self.max_dets[1], "AR10"),
            ("Average Recall", "0.50:0.95", "all", self.max_dets[2], "AR100"),
            ("Average Recall", "0.50:0.95", "small", self.max_dets[2], "ARsmall"),
            ("Average Recall", "0.50:0.95", "medium", self.max_dets[2], "ARmedium"),
            ("Average Recall", "0.50:0.95", "large", self.max_dets[2], "ARlarge"),
        ]
        for label, iou, area, md, key in rows:
            print_fn(tmpl.format(f"{label} ({key})", iou, area, md,
                                 self.metrics[key]))
