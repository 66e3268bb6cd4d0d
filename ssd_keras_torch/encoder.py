"""SSD training-target encoder: ground truth -> dense y_true, on the device.

Port of ``ssd_keras_tpu/encoder.py``. The JAX package vmaps one image's
encode over a padded ``(batch, max_gt, 5)`` label tensor; here every stage
is written over the batch axis directly, with the same fixed shapes, so a
batch encodes on the labels' device with no host round trip:

1. greedy bipartite matching (one anchor per ground-truth box) on a top-M
   reduced matrix, then zeroing of the matched anchor *columns* only;
2. multi matching of every other anchor to its best box at
   ``pos_iou_threshold``;
3. the neutral zone: an unmatched anchor whose best remaining IoU is at
   least ``neg_iou_limit`` gets an all-zero class row, which the loss
   ignores;

then the offsets for 'centroids', 'corners' or 'minmax' coordinates.

Output layout: ``(batch, #boxes, n_classes + 12)`` with
``[one-hot classes | 4 box offsets | 4 anchor coords | 4 variances]``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.devices import target_device
from ssd_keras_torch.ops import boxes as box_ops
from ssd_keras_torch.ops.matching import match_bipartite_greedy_topk, match_multi
from ssd_keras_torch.utils.profiling import spanned

__all__ = ["SSDInputEncoder", "DegenerateBoxError", "encode_targets", "pad_labels"]


class DegenerateBoxError(Exception):
    """Raised when ground truth boxes have xmax <= xmin or ymax <= ymin."""


def pad_labels(
    ground_truth_labels: Sequence[np.ndarray], max_gt: int, truncate: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a ragged list of (k_i, 5) label arrays to (batch, max_gt, 5) + counts.

    Images with more than ``max_gt`` boxes raise by default; with
    ``truncate=True`` the largest-area ``max_gt`` boxes are kept instead
    (useful for crowd-heavy datasets where a few outlier images would
    otherwise force a larger static shape for everyone).
    """
    batch = len(ground_truth_labels)
    padded = np.zeros((batch, max_gt, 5), dtype=np.float32)
    counts = np.zeros((batch,), dtype=np.int32)
    for i, labels in enumerate(ground_truth_labels):
        labels = np.asarray(labels, dtype=np.float32)
        if labels.size == 0:
            continue
        k = labels.shape[0]
        if k > max_gt:
            if not truncate:
                raise ValueError(
                    f"Image {i} has {k} ground truth boxes, exceeding "
                    f"max_gt={max_gt}. Raise `max_gt_boxes` on the encoder "
                    "or pass truncate=True."
                )
            areas = (labels[:, 3] - labels[:, 1]) * (labels[:, 4] - labels[:, 2])
            labels = labels[np.argsort(-areas)[:max_gt]]
            k = max_gt
        padded[i, :k] = labels
        counts[i] = k
    return padded, counts


def _gather_rows(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``values[b, index[b, a]]`` for (B, m, ...) values and (B, N) indices."""
    idx = index.reshape(*index.shape, *([1] * (values.dim() - 2)))
    return values.gather(1, idx.expand(*index.shape, *values.shape[2:]))


def encode_targets(
    labels: torch.Tensor,  # (B, max_gt, 5) float: class, xmin, ymin, xmax, ymax
    n_valid: torch.Tensor,  # (B,) integer
    anchors8: torch.Tensor,  # (N, 8): anchor coords (config format) + variances
    *,
    n_classes_with_bg: int,
    img_height: int,
    img_width: int,
    coords: str,
    normalize_coords: bool,
    border_pixels: str,
    matching_type: str,
    pos_iou_threshold: float,
    neg_iou_limit: float,
    background_id: int,
) -> torch.Tensor:
    """Batched target encoding: (B, max_gt, 5) + (B,) -> (B, #boxes, C+12),
    on the device of ``labels``, which ``n_valid`` and ``anchors8`` share."""
    b, max_gt, _ = labels.shape
    n_anchors = anchors8.shape[0]
    device, dtype = labels.device, anchors8.dtype
    anchor_boxes = anchors8[:, :4]
    variances = anchors8[:, 4:]

    class_ids = labels[..., 0].to(torch.int64)
    corners = labels[..., 1:5].to(dtype)
    if normalize_coords:
        # A device tensor, not a Python scalar: a CUDA division by a scalar
        # multiplies by its reciprocal, which can differ in the last bit.
        scale = torch.tensor([img_width, img_height, img_width, img_height], dtype=dtype)
        corners = corners / scale.to(device, non_blocking=True)
    # Ground truth in the model's internal coordinate format.
    if coords == "centroids":
        gt = box_ops.convert_coordinates(corners, 0, "corners2centroids", border_pixels)
    elif coords == "minmax":
        gt = box_ops.convert_coordinates(corners, 0, "corners2minmax")
    else:
        gt = corners

    valid = torch.arange(max_gt, device=device)[None, :] < n_valid[:, None]  # (B, max_gt)
    # IoU in the internal format; padded rows must never win an argmax, and
    # live IoUs are >= 0.
    similarities = box_ops.iou(
        gt, anchor_boxes, coords=coords, mode="outer_product", border_pixels=border_pixels
    )
    similarities = torch.where(valid[:, :, None], similarities, -1.0)

    # Stage 1: greedy bipartite matching, one anchor per ground-truth box.
    bip_matches = match_bipartite_greedy_topk(similarities, n_valid)  # (B, max_gt)
    hit = bip_matches[:, :, None] == torch.arange(n_anchors, device=device)  # (B, max_gt, N)
    bip_taken = hit.any(dim=1)  # (B, N)
    # assigned[b, a] = the box matched to anchor a, or max_gt if none.
    assigned = torch.where(bip_taken, hit.to(torch.uint8).argmax(dim=1), max_gt)
    # Zero the matched anchor columns; the rows stay live.
    sim_after_bip = similarities * (~bip_taken).to(dtype)[:, None, :]

    # Stage 2: multi matching, each anchor to its best box >= threshold.
    if matching_type == "multi":
        multi_gt, multi_ok = match_multi(sim_after_bip, pos_iou_threshold)
        assigned = torch.where(multi_ok, multi_gt, assigned)
        sim_after_multi = torch.where(multi_ok[:, None, :], 0.0, sim_after_bip)
    else:
        sim_after_multi = sim_after_bip

    # Stage 3: the neutral zone.
    neutral = sim_after_multi.amax(dim=1) >= neg_iou_limit  # (B, N)

    matched = assigned < max_gt
    safe = assigned.clamp(0, max_gt - 1)
    a_class = torch.where(matched, class_ids.gather(1, safe), background_id)
    # A comparison, not F.one_hot: no range check that reads the device, and
    # an out-of-range id gives an all-zero row, as jax.nn.one_hot does.
    one_hot = (a_class[..., None] == torch.arange(n_classes_with_bg, device=device)).to(dtype)
    one_hot = torch.where((neutral & ~matched)[..., None], 0.0, one_hot)

    # Unmatched anchors carry their own coordinates, so their offsets are 0.
    a_gt = torch.where(matched[..., None], _gather_rows(gt, safe), anchor_boxes)

    if coords == "centroids":
        cxy = (a_gt[..., 0:2] - anchor_boxes[:, 0:2]) / (anchor_boxes[:, 2:4] * variances[:, 0:2])
        wh = torch.log(a_gt[..., 2:4] / anchor_boxes[:, 2:4]) / variances[:, 2:4]
        offsets = torch.cat([cxy, wh], dim=-1)
    elif coords == "corners":
        w = (anchor_boxes[:, 2] - anchor_boxes[:, 0])[:, None]
        h = (anchor_boxes[:, 3] - anchor_boxes[:, 1])[:, None]
        offsets = (a_gt - anchor_boxes) / torch.cat([w, h, w, h], dim=1) / variances
    else:  # minmax: (xmin, xmax, ymin, ymax)
        w = (anchor_boxes[:, 1] - anchor_boxes[:, 0])[:, None]
        h = (anchor_boxes[:, 3] - anchor_boxes[:, 2])[:, None]
        offsets = (a_gt - anchor_boxes) / torch.cat([w, w, h, h], dim=1) / variances

    return torch.cat(
        [one_hot, offsets, anchors8.expand(b, n_anchors, 8)], dim=-1
    )


class SSDInputEncoder:
    """Counterpart of the JAX package's ``SSDInputEncoder``.

    Construct from an :class:`SSDConfig` plus the model's predictor sizes and
    the device to encode on (the card unless the caller asks for the CPU; no
    card raises). ``__call__`` takes the ragged list of per-image
    ``(k, 5)`` arrays with rows ``(class_id, xmin, ymin, xmax, ymax)``, checks
    them, and returns the dense ``(batch, #boxes, n_classes + 12)`` y_true as
    NumPy; :meth:`encode_padded` takes padded tensors and returns a tensor on
    the encoder's device.
    """

    def __init__(
        self,
        config: SSDConfig,
        predictor_sizes: Sequence[Tuple[int, int]],
        max_gt_boxes: int = 64,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        self.device = target_device(device)
        self.config = config
        self.predictor_sizes = [tuple(int(v) for v in s) for s in predictor_sizes]
        self.max_gt_boxes = int(max_gt_boxes)
        self.dtype = dtype
        self.anchors8 = torch.tensor(
            config.anchor_tensor(self.predictor_sizes), dtype=dtype, device=self.device
        )
        self.n_boxes_total = int(self.anchors8.shape[0])
        self._static = dict(
            n_classes_with_bg=config.n_classes_with_background,
            img_height=config.img_height,
            img_width=config.img_width,
            coords=config.coords,
            normalize_coords=config.normalize_coords,
            border_pixels=config.border_pixels,
            matching_type=config.matching_type,
            pos_iou_threshold=float(config.pos_iou_threshold),
            neg_iou_limit=float(config.neg_iou_limit),
            background_id=int(config.background_id),
        )

    @spanned("encode")
    def encode_padded(self, labels_padded, n_valid) -> torch.Tensor:
        """Encode padded labels (tensors or arrays) on the encoder's device.
        Tensors already there are used as they are, with no host round trip."""
        labels_padded = torch.as_tensor(labels_padded, dtype=self.dtype, device=self.device)
        n_valid = torch.as_tensor(n_valid, device=self.device)
        return encode_targets(labels_padded, n_valid, self.anchors8, **self._static)

    def __call__(self, ground_truth_labels: List[np.ndarray], diagnostics: bool = False):
        for i, labels in enumerate(ground_truth_labels):
            labels = np.asarray(labels)
            if labels.size == 0:
                continue
            class_ids = labels[:, 0]
            if np.any(class_ids < 1) or np.any(
                class_ids >= self.config.n_classes_with_background
            ):
                raise ValueError(
                    f"Batch item {i} contains class IDs outside "
                    f"[1, {self.config.n_classes}]: {np.unique(class_ids).tolist()}. "
                    "Class 0 is reserved for the background."
                )
            if np.any(labels[:, 3] - labels[:, 1] <= 0) or np.any(
                labels[:, 4] - labels[:, 2] <= 0
            ):
                raise DegenerateBoxError(
                    f"SSDInputEncoder detected degenerate ground truth bounding "
                    f"boxes for batch item {i} with bounding boxes {labels}: "
                    "boxes where xmax <= xmin and/or ymax <= ymin would lead to "
                    "NaN errors during training."
                )
        padded, counts = pad_labels(ground_truth_labels, self.max_gt_boxes)
        y = self.encode_padded(padded, counts).cpu().numpy()
        if diagnostics:
            y_matched = y.copy()
            y_matched[:, :, -12:-8] = 0.0
            return y, y_matched
        return y
