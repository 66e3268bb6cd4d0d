"""Fixed-shape decoding of raw SSD predictions into detections (PyTorch).

Port of the in-graph decoders of ``ssd_keras_tpu/decoder.py``:
:func:`decode_detections_fixed` (the Caffe-faithful per-class decode of the
``inference`` mode) and :func:`decode_detections_fast_fixed` (argmax class,
one NMS per image, the ``inference_fast`` mode). Both return a static
``(batch, top_k, 6)`` tensor ``[class_id, conf, xmin, ymin, xmax, ymax]``,
zero-padded, on the input's device.

NMS runs through ``kernels/nms.py``: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors. Every top-k is a stable descending
sort, which breaks ties lowest index first as ``lax.top_k`` does.
Thresholds are rounded to f32 before comparing, as JAX compares f32 arrays
with a Python float.

Under data parallelism each rank decodes its own rows of the global batch,
so the NMS kernel runs on that rank's ``B_local * (C - 1)`` lanes: what the
JAX package's ``custom_partitioning`` rule for its kernel
(``kernels/nms_pallas.py:_nms_partition``) arranges on a mesh, lanes split
over the devices and each candidate list whole on one.
``parallel.sharding.global_batch_from_local`` assembles the global batch's
detections in rank order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ssd_keras_torch.kernels.nms import greedy_nms_mask_batched
from ssd_keras_torch.ops.boxes import border_delta as _border_delta

__all__ = ["decode_offsets", "decode_detections_fixed", "decode_detections_fast_fixed"]


def _f32(x: float) -> float:
    return float(np.float32(x))


def _topk(scores: torch.Tensor, k: int):
    """Top-k over the last axis, score-descending, ties lowest index first."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode_offsets(
    y_pred: torch.Tensor,
    input_coords: str = "centroids",
    normalize_coords: bool = True,
    img_height: Optional[int] = None,
    img_width: Optional[int] = None,
) -> torch.Tensor:
    """Invert the encoder's offset/variance algebra.

    ``y_pred``: (..., #boxes, n_classes + 12). Returns corner-format absolute
    (or still-normalized if ``normalize_coords=False``) coordinates of shape
    (..., #boxes, 4). Parity: ssd_output_decoder.py:174-198.
    """
    anchors = y_pred[..., -8:-4]
    variances = y_pred[..., -4:]
    offsets = y_pred[..., -12:-8]

    if input_coords == "centroids":
        wh = torch.exp(offsets[..., 2:4] * variances[..., 2:4]) * anchors[..., 2:4]
        cxy = offsets[..., 0:2] * variances[..., 0:2] * anchors[..., 2:4] + anchors[..., 0:2]
        cx, cy, w, h = cxy[..., 0], cxy[..., 1], wh[..., 0], wh[..., 1]
        corners = torch.stack(
            (cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0), dim=-1
        )
    elif input_coords == "minmax":
        w = (anchors[..., 1] - anchors[..., 0])[..., None]
        h = (anchors[..., 3] - anchors[..., 2])[..., None]
        size = torch.cat([w, w, h, h], dim=-1)
        mm = offsets * variances * size + anchors
        corners = torch.stack((mm[..., 0], mm[..., 2], mm[..., 1], mm[..., 3]), dim=-1)
    elif input_coords == "corners":
        w = (anchors[..., 2] - anchors[..., 0])[..., None]
        h = (anchors[..., 3] - anchors[..., 1])[..., None]
        size = torch.cat([w, h, w, h], dim=-1)
        corners = offsets * variances * size + anchors
    else:
        raise ValueError(f"Unexpected input_coords {input_coords!r}.")

    if normalize_coords:
        if img_height is None or img_width is None:
            raise ValueError(
                "img_height and img_width are required when normalize_coords=True."
            )
        # Scalar multiplies, not a (4,) tensor from the host: that copy would
        # make the host wait for the device.
        x1, y1, x2, y2 = corners.unbind(-1)
        corners = torch.stack(
            (x1 * img_width, y1 * img_height, x2 * img_width, y2 * img_height), dim=-1
        )
    return corners


def _resolve_compact_pool(compact_pool, n, pool):
    """Cross-class compaction pool size: ``'auto'`` is M=512 whenever the
    model has more boxes than that; ``None``/0 is off; an int is that many
    boxes, never fewer than the NMS pool."""
    if compact_pool == "auto":
        compact_pool = 512
    m = int(compact_pool or 0)
    if m <= 0 or m >= n:
        return 0
    return max(m, pool)


def _finish(flat_scores, flat_classes, flat_boxes, top_k):
    """Global top-k over one image's survivors, zeroed where the score is 0,
    zero-padded to ``top_k`` rows: (B, top_k, 6)."""
    k_eff = min(top_k, flat_scores.shape[1])
    top_scores, top_idx = _topk(flat_scores, k_eff)
    out = torch.cat(
        [
            torch.gather(flat_classes, 1, top_idx)[..., None],
            top_scores[..., None],
            torch.gather(flat_boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
        ],
        dim=2,
    )
    out = torch.where((top_scores > 0.0)[..., None], out, 0.0)
    if k_eff < top_k:
        out = torch.nn.functional.pad(out, (0, 0, 0, top_k - k_eff))
    return out


def _decode_caffe_batched(
    confs,  # (B, N, C) softmax confidences
    corners,  # (B, N, 4)
    *, confidence_thresh, iou_threshold, top_k, nms_max_output_size,
    nms_candidates=None, border_delta=0.0, compact_pool="auto",
):
    """Per-class threshold + NMS, then a global per-image top-k, with every
    (batch, class) pair an independent NMS lane. See
    ``ssd_keras_tpu/decoder.py:_decode_caffe_batched`` for the candidate-pool
    and compaction exactness arguments."""
    b, n, c = confs.shape
    pool = max(nms_candidates or 0, nms_max_output_size)
    k = min(pool, n)
    thresh = _f32(confidence_thresh)

    m = _resolve_compact_pool(compact_pool, n, pool)
    if m:
        cls_scores = confs[:, :, 1:]  # (B, N, C-1); class 0 skipped
        _, box_idx = _topk(cls_scores.amax(dim=-1), m)  # (B, M)
        scores = torch.gather(
            cls_scores, 1, box_idx[..., None].expand(-1, -1, c - 1)
        ).transpose(1, 2)  # (B, C-1, M)
        corners = torch.gather(corners, 1, box_idx[..., None].expand(-1, -1, 4))
        k = min(k, m)
    else:
        scores = confs[:, :, 1:].transpose(1, 2)  # (B, C-1, N)
    masked = torch.where(scores > thresh, scores, -1.0)
    cand_scores, cand_idx = _topk(masked, k)  # (B, C-1, K)
    cand_boxes = torch.gather(
        corners[:, None].expand(-1, c - 1, -1, -1), 2,
        cand_idx[..., None].expand(-1, -1, -1, 4),
    )  # (B, C-1, K, 4)
    valid = cand_scores > thresh

    # The gathers can return strided tensors (at batch 1 they do); the NMS
    # kernel takes contiguous ones.
    keep = greedy_nms_mask_batched(
        cand_boxes.reshape(b * (c - 1), k, 4).contiguous(),
        valid.reshape(b * (c - 1), k).contiguous(),
        iou_threshold,
        border_delta,
    ).reshape(b, c - 1, k)
    if k > nms_max_output_size:
        # At most nms_max_output_size survivors per class; candidates are
        # score-descending, so survivors are too.
        keep = keep & (torch.cumsum(keep, dim=-1) <= nms_max_output_size)

    kept_scores = torch.where(keep, cand_scores, 0.0)
    class_ids = torch.arange(1, c, dtype=confs.dtype, device=confs.device)
    class_ids = class_ids[None, :, None].expand(b, -1, k)
    return _finish(
        kept_scores.reshape(b, -1), class_ids.reshape(b, -1),
        cand_boxes.reshape(b, -1, 4), top_k,
    )


def decode_detections_fixed(
    y_pred: torch.Tensor,
    confidence_thresh: float = 0.01,
    iou_threshold: float = 0.45,
    top_k: int = 200,
    nms_max_output_size: int = 400,
    input_coords: str = "centroids",
    normalize_coords: bool = True,
    img_height: Optional[int] = None,
    img_width: Optional[int] = None,
    nms_candidates: Optional[int] = None,
    border_pixels: str = "half",
    compact_pool="auto",
) -> torch.Tensor:
    """Caffe-faithful decode -> ``(batch, top_k, 6)``.

    Per-class confidence threshold (strict >), per-class greedy NMS capped at
    ``nms_max_output_size`` survivors over a static candidate pool
    (``nms_candidates``, default ``nms_max_output_size``), then a global
    top-k over all classes, zero-padded. ``compact_pool``: cross-class
    candidate compaction before the per-class top-k ('auto' = the top 512
    boxes by max class score whenever there are more boxes than that; an
    int forces a pool size; None/0 disables it).
    """
    corners = decode_offsets(y_pred, input_coords, normalize_coords, img_height, img_width)
    return _decode_caffe_batched(
        y_pred[..., :-12],
        corners,
        confidence_thresh=confidence_thresh,
        iou_threshold=iou_threshold,
        top_k=top_k,
        nms_max_output_size=nms_max_output_size,
        nms_candidates=nms_candidates,
        border_delta=_border_delta(border_pixels),
        compact_pool=compact_pool,
    )


def _decode_fast_batched(
    confs, corners, *, confidence_thresh, iou_threshold, top_k,
    nms_max_output_size, nms_candidates=None, border_delta=0.0,
):
    """Argmax class first, one global NMS per image (each image one lane)."""
    b, n, _ = confs.shape
    pool = max(nms_candidates or 0, nms_max_output_size)
    k = min(pool, n)
    conf, class_id = confs.max(dim=-1)  # first index among equal maxima
    eligible = (class_id != 0) & (conf >= _f32(confidence_thresh))
    masked = torch.where(eligible, conf, -1.0)
    cand_scores, cand_idx = _topk(masked, k)  # (B, K)
    cand_boxes = torch.gather(corners, 1, cand_idx[..., None].expand(-1, -1, 4))
    cand_classes = torch.gather(class_id, 1, cand_idx).to(confs.dtype)
    valid = cand_scores > 0.0
    keep = greedy_nms_mask_batched(cand_boxes, valid, iou_threshold, border_delta)
    if k > nms_max_output_size:
        keep = keep & (torch.cumsum(keep, dim=-1) <= nms_max_output_size)
    scores = torch.where(keep, cand_scores, 0.0)
    return _finish(scores, cand_classes, cand_boxes, top_k)


def decode_detections_fast_fixed(
    y_pred: torch.Tensor,
    confidence_thresh: float = 0.5,
    iou_threshold: float = 0.45,
    top_k: int = 200,
    nms_max_output_size: int = 400,
    input_coords: str = "centroids",
    normalize_coords: bool = True,
    img_height: Optional[int] = None,
    img_width: Optional[int] = None,
    nms_candidates: Optional[int] = None,
    border_pixels: str = "half",
) -> torch.Tensor:
    """Fast decode (argmax class, global NMS) -> ``(batch, top_k, 6)``.

    Parity with ``DecodeDetectionsFast``: the highest-confidence class wins,
    background boxes are dropped, one global NMS per image capped at
    ``nms_max_output_size`` survivors over a static candidate pool.
    """
    corners = decode_offsets(y_pred, input_coords, normalize_coords, img_height, img_width)
    return _decode_fast_batched(
        y_pred[..., :-12],
        corners,
        confidence_thresh=confidence_thresh,
        iou_threshold=iou_threshold,
        top_k=top_k,
        nms_max_output_size=nms_max_output_size,
        nms_candidates=nms_candidates,
        border_delta=_border_delta(border_pixels),
    )

