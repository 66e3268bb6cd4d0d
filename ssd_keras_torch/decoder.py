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

The host decoders (:func:`decode_detections`, :func:`decode_detections_fast`,
:func:`decode_detections_debug` and their helpers) are vendored from the JAX
package's NumPy ones: ragged per-image lists, f64 rows, a NumPy
:func:`decode_offsets_np`, and greedy NMS through the host C++ of
``native/`` (``greedy_nms_numpy`` is the NumPy loop, the plain version).

Under data parallelism each rank decodes its own rows of the global batch,
so the NMS kernel runs on that rank's ``B_local * (C - 1)`` lanes: what the
JAX package's ``custom_partitioning`` rule for its kernel
(``kernels/nms_pallas.py:_nms_partition``) arranges on a mesh, lanes split
over the devices and each candidate list whole on one.
``parallel.sharding.global_batch_from_local`` assembles the global batch's
detections in rank order.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ssd_keras_torch import native
from ssd_keras_torch.kernels.nms import greedy_nms_mask_batched
from ssd_keras_torch.ops import boxes as box_ops
from ssd_keras_torch.ops.boxes import border_delta as _border_delta
from ssd_keras_torch.utils.profiling import count, span

__all__ = [
    "decode_offsets",
    "decode_detections_fixed",
    "decode_detections_fast_fixed",
    "decode_offsets_np",
    "decode_detections",
    "decode_detections_fast",
    "decode_detections_debug",
    "get_num_boxes_per_pred_layer",
    "get_pred_layers",
    "greedy_nms",
    "greedy_nms_numpy",
]


def _f32(x: float) -> float:
    return float(np.float32(x))


def _topk_lanes(scores: torch.Tensor, k: int):
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
    top_scores, top_idx = _topk_lanes(flat_scores, k_eff)
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


# The stages of the Caffe decode, in the order ``_decode_caffe_batched``
# calls them (``ssd_keras_torch.examples.profile_breakdown`` times each one):
# ``compact_candidates`` -> ``_per_class_topk`` -> ``_nms_lanes`` ->
# ``_global_topk``.


def compact_candidates(confs, corners, m: int):
    """Cross-class compaction: the top ``m`` boxes of each image by their
    max non-background score, as class-major scores (B, C-1, m) and their
    corners (B, m, 4). ``m`` = 0 compacts nothing: the class-major view of
    all N boxes, and the corners as given."""
    cls_scores = confs[:, :, 1:]  # (B, N, C-1); class 0 skipped
    if not m:
        return cls_scores.transpose(1, 2), corners
    _, box_idx = _topk_lanes(cls_scores.amax(dim=-1), m)  # (B, M)
    scores = torch.gather(
        cls_scores, 1, box_idx[..., None].expand(-1, -1, cls_scores.shape[-1])
    ).transpose(1, 2)  # (B, C-1, M)
    corners = torch.gather(corners, 1, box_idx[..., None].expand(-1, -1, 4))
    return scores, corners


def _per_class_topk(scores, corners, k: int, thresh: float):
    """The per-class threshold (strict >) and the top ``k`` candidates of
    each (image, class) lane, from class-major ``scores`` (B, C-1, N') and
    ``corners`` (B, N', 4). Returns the candidates' scores (B, C-1, K),
    boxes (B, C-1, K, 4) and valid mask (B, C-1, K)."""
    masked = torch.where(scores > thresh, scores, -1.0)
    cand_scores, cand_idx = _topk_lanes(masked, k)  # (B, C-1, K)
    cand_boxes = torch.gather(
        corners[:, None].expand(-1, scores.shape[1], -1, -1), 2,
        cand_idx[..., None].expand(-1, -1, -1, 4),
    )  # (B, C-1, K, 4)
    return cand_scores, cand_boxes, cand_scores > thresh


def _nms_lanes(cand_boxes, valid, iou_threshold, border_delta, max_output_size):
    """Greedy-NMS keep mask (..., K) of boxes (..., K, 4) and valid (..., K),
    the leading axes flattened into the kernel's lanes; at most
    ``max_output_size`` survivors a lane. Counts the lanes in
    ``decode.lanes``."""
    k = valid.shape[-1]
    count("decode.lanes", valid.numel() // k if k else 0)
    # The gathers can return strided tensors (at batch 1 they do); the NMS
    # kernel takes contiguous ones.
    keep = greedy_nms_mask_batched(
        cand_boxes.reshape(-1, k, 4).contiguous(),
        valid.reshape(-1, k).contiguous(),
        iou_threshold,
        border_delta,
    ).reshape(valid.shape)
    if k > max_output_size:
        # Candidates are score-descending, so survivors are too.
        keep = keep & (torch.cumsum(keep, dim=-1) <= max_output_size)
    return keep


def _global_topk(keep, cand_scores, cand_boxes, top_k: int):
    """The per-image top ``top_k`` over every class's survivors of
    ``_nms_lanes``: (B, top_k, 6) rows ``[class_id, conf, xmin, ymin, xmax,
    ymax]``."""
    b, n_cls, k = keep.shape
    kept_scores = torch.where(keep, cand_scores, 0.0)
    class_ids = torch.arange(1, n_cls + 1, dtype=cand_scores.dtype, device=keep.device)
    class_ids = class_ids[None, :, None].expand(b, -1, k)
    return _finish(
        kept_scores.reshape(b, -1), class_ids.reshape(b, -1),
        cand_boxes.reshape(b, -1, 4), top_k,
    )


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
    n = confs.shape[1]
    pool = max(nms_candidates or 0, nms_max_output_size)
    m = _resolve_compact_pool(compact_pool, n, pool)
    with span("decode.compact"):
        scores, corners = compact_candidates(confs, corners, m)
    with span("decode.topk"):
        cand_scores, cand_boxes, valid = _per_class_topk(
            scores, corners, min(pool, n, m or n), _f32(confidence_thresh))
    with span("decode.nms"):
        keep = _nms_lanes(cand_boxes, valid, iou_threshold, border_delta, nms_max_output_size)
    with span("decode.global_topk"):
        return _global_topk(keep, cand_scores, cand_boxes, top_k)


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
    cand_scores, cand_idx = _topk_lanes(masked, k)  # (B, K)
    cand_boxes = torch.gather(corners, 1, cand_idx[..., None].expand(-1, -1, 4))
    cand_classes = torch.gather(class_id, 1, cand_idx).to(confs.dtype)
    keep = _nms_lanes(cand_boxes, cand_scores > 0.0, iou_threshold, border_delta,
                      nms_max_output_size)
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



# --------------------------------------------------------------------------- #
# Host-side ragged decoders (NumPy), vendored from ssd_keras_tpu/decoder.py
# --------------------------------------------------------------------------- #


def decode_offsets_np(
    y_pred: np.ndarray,
    input_coords: str = "centroids",
    normalize_coords: bool = True,
    img_height: Optional[int] = None,
    img_width: Optional[int] = None,
) -> np.ndarray:
    """:func:`decode_offsets` in NumPy, in the dtype and op order of the JAX
    package's ``decode_offsets(..., xp=np)`` (the host decoders' boxes)."""
    anchors = y_pred[..., -8:-4]
    variances = y_pred[..., -4:]
    offsets = y_pred[..., -12:-8]

    if input_coords == "centroids":
        wh = np.exp(offsets[..., 2:4] * variances[..., 2:4]) * anchors[..., 2:4]
        cxy = offsets[..., 0:2] * variances[..., 0:2] * anchors[..., 2:4] + anchors[..., 0:2]
        cent = np.concatenate([cxy, wh], axis=-1)
        corners = box_ops.convert_coordinates(cent, -4, "centroids2corners")
    elif input_coords == "minmax":
        w = (anchors[..., 1] - anchors[..., 0])[..., None]
        h = (anchors[..., 3] - anchors[..., 2])[..., None]
        size = np.concatenate([w, w, h, h], axis=-1)
        mm = offsets * variances * size + anchors
        corners = box_ops.convert_coordinates(mm, -4, "minmax2corners")
    elif input_coords == "corners":
        w = (anchors[..., 2] - anchors[..., 0])[..., None]
        h = (anchors[..., 3] - anchors[..., 1])[..., None]
        size = np.concatenate([w, h, w, h], axis=-1)
        corners = offsets * variances * size + anchors
    else:
        raise ValueError(f"Unexpected input_coords {input_coords!r}.")

    if normalize_coords:
        if img_height is None or img_width is None:
            raise ValueError(
                "img_height and img_width are required when normalize_coords=True."
            )
        scale = np.asarray([img_width, img_height, img_width, img_height], dtype=corners.dtype)
        corners = corners * scale
    return corners


def _nms_rows(rows: np.ndarray, score_col: int, iou_threshold: float, border_pixels: str):
    """Greedy NMS (host C++) over rows ``[..., score, 4 corners]`` whose
    score is column ``score_col``; the survivors in selection order."""
    rows = np.asarray(rows)
    keep = native.greedy_nms_indices(
        rows[:, score_col], rows[:, score_col + 1:score_col + 5], iou_threshold,
        _border_delta(border_pixels),
    )
    return rows[keep]


def _nms_rows_numpy(rows: np.ndarray, score_col: int, iou_threshold: float,
                    border_pixels: str):
    """The plain version of :func:`_nms_rows`: the NumPy loop (f64 IoU)."""
    boxes_left = np.copy(rows)
    maxima = []
    box_cols = slice(score_col + 1, score_col + 5)
    while boxes_left.shape[0] > 0:
        i = np.argmax(boxes_left[:, score_col])
        maximum = np.copy(boxes_left[i])
        maxima.append(maximum)
        boxes_left = np.delete(boxes_left, i, axis=0)
        if boxes_left.shape[0] == 0:
            break
        sims = box_ops.iou_np(
            boxes_left[:, box_cols], maximum[box_cols], coords="corners",
            mode="element-wise", border_pixels=border_pixels,
        )
        boxes_left = boxes_left[sims <= iou_threshold]
    return np.array(maxima)


def greedy_nms(boxes_scores: np.ndarray, iou_threshold: float = 0.45,
               border_pixels: str = "half") -> np.ndarray:
    """Greedy NMS over (k, 5+) rows ``[score, xmin, ymin, xmax, ymax, ...]``
    through the host C++; the surviving rows in selection (score-descending)
    order. Parity: ssd_output_decoder.py:77-92 (`_greedy_nms`)."""
    return _nms_rows(boxes_scores, 0, iou_threshold, border_pixels)


def greedy_nms_numpy(boxes_scores: np.ndarray, iou_threshold: float = 0.45,
                     border_pixels: str = "half") -> np.ndarray:
    """The plain version of :func:`greedy_nms`: the NumPy loop the JAX
    package runs without its native library."""
    return _nms_rows_numpy(boxes_scores, 0, iou_threshold, border_pixels)


def _top_k_rows(pred: np.ndarray, top_k, score_col: int) -> np.ndarray:
    if top_k != "all" and pred.shape[0] > top_k:
        kth = pred.shape[0] - top_k
        idx = np.argpartition(pred[:, score_col], kth=kth, axis=0)[kth:]
        pred = pred[idx]
    return pred


def decode_detections(
    y_pred: np.ndarray,
    confidence_thresh: float = 0.01,
    iou_threshold: float = 0.45,
    top_k=200,
    input_coords: str = "centroids",
    normalize_coords: bool = True,
    img_height: Optional[int] = None,
    img_width: Optional[int] = None,
    border_pixels: str = "half",
) -> List[np.ndarray]:
    """Host decode with per-class NMS; returns a ragged list of (k, 6) arrays.

    Rows are ``[class_id, confidence, xmin, ymin, xmax, ymax]``.
    Parity: ssd_output_decoder.py:111-226.
    """
    y_pred = np.asarray(y_pred)
    corners = decode_offsets_np(y_pred, input_coords, normalize_coords, img_height, img_width)
    n_classes = y_pred.shape[-1] - 12

    results = []
    for b in range(y_pred.shape[0]):
        pred = []
        for class_id in range(1, n_classes):
            scores = y_pred[b, :, class_id]
            mask = scores > confidence_thresh
            if not np.any(mask):
                continue
            cand = np.concatenate([scores[mask][:, None], corners[b][mask]], axis=1)
            maxima = greedy_nms(cand, iou_threshold, border_pixels)
            out = np.zeros((maxima.shape[0], 6))
            out[:, 0] = class_id
            out[:, 1:] = maxima
            pred.append(out)
        if pred:
            pred = _top_k_rows(np.concatenate(pred, axis=0), top_k, 1)
        else:
            pred = np.zeros((0, 6))
        results.append(pred)
    return results


def decode_detections_fast(
    y_pred: np.ndarray,
    confidence_thresh: float = 0.5,
    iou_threshold: Optional[float] = 0.45,
    top_k="all",
    input_coords: str = "centroids",
    normalize_coords: bool = True,
    img_height: Optional[int] = None,
    img_width: Optional[int] = None,
    border_pixels: str = "half",
) -> List[np.ndarray]:
    """Host decode with argmax class + global NMS; ragged list of (k, 6).

    Parity: ssd_output_decoder.py:228-333.
    """
    y_pred = np.asarray(y_pred)
    corners = decode_offsets_np(y_pred, input_coords, normalize_coords, img_height, img_width)
    class_ids = np.argmax(y_pred[:, :, :-12], axis=-1)
    confs = np.amax(y_pred[:, :, :-12], axis=-1)

    results = []
    for b in range(y_pred.shape[0]):
        mask = class_ids[b] != 0
        boxes = np.concatenate(
            [
                class_ids[b][mask][:, None].astype(np.float64),
                confs[b][mask][:, None],
                corners[b][mask],
            ],
            axis=1,
        )
        boxes = boxes[boxes[:, 1] >= confidence_thresh]
        if iou_threshold and boxes.shape[0] > 0:
            boxes = _nms_rows(boxes, 1, iou_threshold, border_pixels)
        results.append(_top_k_rows(boxes, top_k, 1))
    return results


def decode_detections_debug(
    y_pred: np.ndarray,
    confidence_thresh: float = 0.01,
    iou_threshold: float = 0.45,
    top_k=200,
    input_coords: str = "centroids",
    normalize_coords: bool = True,
    img_height: Optional[int] = None,
    img_width: Optional[int] = None,
    variance_encoded_in_target: bool = False,
    border_pixels: str = "half",
) -> List[np.ndarray]:
    """Host decode that keeps each box's internal anchor index.

    Output rows are ``[box_id, class_id, confidence, xmin, ymin, xmax, ymax]``
    so every final detection can be attributed to the predictor layer that
    produced it (with :func:`get_pred_layers`). Parity:
    ssd_output_decoder.py:342-467.
    """
    y_pred = np.asarray(y_pred)
    if variance_encoded_in_target:
        # Offsets were encoded without the variance division.
        y = np.array(y_pred)
        y[..., -4:] = 1.0
        corners = decode_offsets_np(y, input_coords, normalize_coords, img_height, img_width)
    else:
        corners = decode_offsets_np(y_pred, input_coords, normalize_coords, img_height,
                                    img_width)
    n_classes = y_pred.shape[-1] - 12
    box_ids = np.arange(y_pred.shape[1], dtype=np.float64)

    results = []
    for b in range(y_pred.shape[0]):
        pred = []
        for class_id in range(1, n_classes):
            scores = y_pred[b, :, class_id]
            mask = scores > confidence_thresh
            if not np.any(mask):
                continue
            cand = np.concatenate(
                [box_ids[mask][:, None], scores[mask][:, None], corners[b][mask]], axis=1,
            )
            maxima = _nms_rows(cand, 1, iou_threshold, border_pixels)
            out = np.zeros((maxima.shape[0], 7))
            out[:, 0] = maxima[:, 0]  # box id
            out[:, 1] = class_id
            out[:, 2:] = maxima[:, 1:]
            pred.append(out)
        if pred:
            pred = _top_k_rows(np.concatenate(pred, axis=0), top_k, 2)
        else:
            pred = np.zeros((0, 7))
        results.append(pred)
    return results


def get_num_boxes_per_pred_layer(predictor_sizes, aspect_ratios, two_boxes_for_ar1):
    """Boxes contributed by each predictor layer (ssd_output_decoder.py:488)."""
    counts = []
    for (h, w), ars in zip(predictor_sizes, aspect_ratios):
        n = len(ars) + (1 if (1 in ars and two_boxes_for_ar1) else 0)
        counts.append(int(h) * int(w) * n)
    return counts


def get_pred_layers(y_pred_decoded, num_boxes_per_pred_layer):
    """Attribute debug-decoded boxes to predictor layers by anchor index.

    Parity: ssd_output_decoder.py:503-530.
    """
    cumulative = np.cumsum(num_boxes_per_pred_layer)
    all_layers = []
    for batch_item in y_pred_decoded:
        layers = []
        for prediction in batch_item:
            box_id = prediction[0]
            if box_id < 0 or box_id >= cumulative[-1]:
                raise ValueError(
                    f"Box index {box_id} out of bounds for {cumulative[-1]} total boxes."
                )
            layers.append(int(np.searchsorted(cumulative, box_id, side="right")))
        all_layers.append(layers)
    return all_layers
