"""Pascal-VOC-style mean-average-precision evaluator (PyTorch port).

Port of ``ssd_keras_tpu/eval/evaluator.py``: dataset-wide prediction (resize
or pad-then-resize input modes, inverse-transform mapping back to original
coordinates), eval-neutral ("difficult") handling, greedy
confidence-descending prediction/GT matching with duplicate-detection->FP,
both the pre-2010 11-point-sample and the post-2010 integrated AP
algorithms, and VOC-format results-file export.

The model is any callable ``model(batch) -> tensor`` on ``device``: each
batch of images is uploaded there (pinned, ``non_blocking``) as it comes
from the data generator, or, in the 'resize' mode over lazily read JPEG
files decoded on the card, made there (``DataGenerator._generate_on_card``:
nvJPEG, the colour kernel and the resize kernel) and passed as it is. A
'training'-mode model's raw predictions are decoded on the device by
``decoder.decode_detections_fixed`` (the NMS kernel on the card), or with
``device_decode=False`` by the host decoder. Dispatch and drain are
pipelined as in the JAX package: the device computes batch N while the
host prepares batch N+1, and each batch's detections cross back through a
pinned buffer and a CUDA event, read only when the batch is drained.
Matching runs in the host C++ (``native``); its NumPy loop is the plain
version (:meth:`Evaluator.match_predictions_numpy`). The rest is host
NumPy vendored from the JAX package.

Spans (``utils.profiling``): ``eval.predict`` over a pass's prediction, in
it per batch (the id) ``data.batch`` (the generator's ``next``, with the
generator's own ``data.*`` stages, ``data.resize`` the resize kernel's
launch where the batch stays on the card), ``eval.dispatch`` (upload,
forward, device decode) and ``eval.drain`` (``eval.read``, the wait for the
detections, and ``eval.bucket``, the inverse transforms and the per-box
loop); then ``eval.num_gt``, ``eval.match``, ``eval.precision_recall``,
``eval.ap`` and ``eval.map``. The counters ``eval.images`` and
``eval.detections`` count the images predicted and the boxes bucketed.
"""

from __future__ import annotations

import functools
from collections import deque
from math import ceil
from typing import Callable

import numpy as np
import torch

from ssd_keras_torch import native
from ssd_keras_torch.data.datasets import DataGenerator
from ssd_keras_torch.data.geometric import Resize
from ssd_keras_torch.data.misc import apply_inverse_transforms
from ssd_keras_torch.data.patch_sampling import RandomPadFixedAR
from ssd_keras_torch.data.photometric import ConvertTo3Channels
from ssd_keras_torch.decoder import decode_detections, decode_detections_fixed
from ssd_keras_torch.devices import target_device
from ssd_keras_torch.ops import boxes as box_ops
from ssd_keras_torch.utils.profiling import count, span, spanned

__all__ = ["Evaluator", "upload_batch", "HostCopy"]


def upload_batch(batch, device: torch.device) -> torch.Tensor:
    """A host image batch as a tensor on ``device``: through pinned memory
    and a copy that does not make the host wait, on a CUDA device. A tensor
    already on ``device`` passes as it is."""
    if isinstance(batch, torch.Tensor):
        return batch if batch.device == device else batch.to(device)
    x = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """A tensor's copy on the host, started now and read later: a CUDA
    tensor goes to a pinned buffer with a non-blocking copy and an event
    behind it; :meth:`numpy` waits for that event only."""

    def __init__(self, value):
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        value = value.detach()
        self.event = None
        if value.device.type == "cuda":
            self.host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            self.host.copy_(value, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = value

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _batches(n_batches, verbose, desc):
    if verbose:
        try:
            from tqdm import trange

            return trange(n_batches, desc=desc)
        except ImportError:
            pass
    return range(n_batches)


class Evaluator:
    """Computes mAP of an SSD model over a ``DataGenerator``.

    ``model``: a callable ``(B, H, W, 3) tensor on device -> tensor`` (an SSD
    module or any function); ``device``: where batches go (the card unless
    the caller asks for the CPU; no card raises).
    """

    def __init__(
        self,
        model: Callable[[torch.Tensor], torch.Tensor],
        n_classes: int,
        data_generator,
        model_mode: str = "inference",
        pred_format=None,
        gt_format=None,
        device="cuda",
    ):
        self.device = target_device(device)
        self.model = model
        self.n_classes = n_classes
        self.data_generator = data_generator
        self.model_mode = model_mode
        self.pred_format = dict(
            pred_format
            or {"class_id": 0, "conf": 1, "xmin": 2, "ymin": 3, "xmax": 4, "ymax": 5}
        )
        self.gt_format = dict(
            gt_format or {"class_id": 0, "xmin": 1, "ymin": 2, "xmax": 3, "ymax": 4}
        )
        self.prediction_results = None
        self.num_gt_per_class = None
        self.true_positives = None
        self.false_positives = None
        self.cumulative_true_positives = None
        self.cumulative_false_positives = None
        self.cumulative_precisions = None
        self.cumulative_recalls = None
        self.average_precisions = None
        self.mean_average_precision = None

    # ------------------------------------------------------------------ #

    def __call__(
        self,
        img_height,
        img_width,
        batch_size,
        data_generator_mode="resize",
        round_confidences=False,
        matching_iou_threshold=0.5,
        border_pixels="include",
        sorting_algorithm="quicksort",
        average_precision_mode="sample",
        num_recall_points=11,
        ignore_neutral_boxes=True,
        return_precisions=False,
        return_recalls=False,
        return_average_precisions=False,
        verbose=True,
        decoding_confidence_thresh=0.01,
        decoding_iou_threshold=0.45,
        decoding_top_k=200,
        decoding_pred_coords="centroids",
        decoding_normalize_coords=True,
    ):
        self.predict_on_dataset(
            img_height=img_height,
            img_width=img_width,
            batch_size=batch_size,
            data_generator_mode=data_generator_mode,
            decoding_confidence_thresh=decoding_confidence_thresh,
            decoding_iou_threshold=decoding_iou_threshold,
            decoding_top_k=decoding_top_k,
            decoding_pred_coords=decoding_pred_coords,
            decoding_normalize_coords=decoding_normalize_coords,
            decoding_border_pixels=border_pixels,
            round_confidences=round_confidences,
            verbose=verbose,
        )
        self.get_num_gt_per_class(ignore_neutral_boxes=ignore_neutral_boxes, verbose=False)
        self.match_predictions(
            ignore_neutral_boxes=ignore_neutral_boxes,
            matching_iou_threshold=matching_iou_threshold,
            border_pixels=border_pixels,
            sorting_algorithm=sorting_algorithm,
            verbose=verbose,
        )
        self.compute_precision_recall()
        self.compute_average_precisions(
            mode=average_precision_mode, num_recall_points=num_recall_points
        )
        mean_ap = self.compute_mean_average_precision()

        out = [mean_ap]
        if return_average_precisions:
            out.append(self.average_precisions)
        if return_precisions:
            out.append(self.cumulative_precisions)
        if return_recalls:
            out.append(self.cumulative_recalls)
        return out[0] if len(out) == 1 else tuple(out)

    # ------------------------------------------------------------------ #

    @spanned("eval.predict")
    def predict_on_dataset(
        self,
        img_height,
        img_width,
        batch_size,
        data_generator_mode="resize",
        decoding_confidence_thresh=0.01,
        decoding_iou_threshold=0.45,
        decoding_top_k=200,
        decoding_pred_coords="centroids",
        decoding_normalize_coords=True,
        decoding_border_pixels="include",
        round_confidences=False,
        verbose=True,
        ret=False,
        device_decode=True,
        decoding_compact_pool="auto",
    ):
        """Run the model over the whole dataset and bucket boxes per class.

        With ``device_decode`` (default), 'training'-mode raw predictions are
        decoded on ``device`` by ``decode_detections_fixed`` with the
        DecodeDetections-layer selection semantics, honoring
        ``decoding_border_pixels`` for the NMS IoU. Its one approximation
        against the host decoder is the static NMS candidate pool (top
        ``nms_max_output_size`` per class after the cross-class compaction
        ``decoding_compact_pool``, 'auto' = the top 512 boxes). Set False for
        the host NumPy decoder (no candidate cap): the raw predictions then
        cross to the host.
        """
        pf = self.pred_format
        transformations = [ConvertTo3Channels()]
        if data_generator_mode == "pad":
            transformations.append(
                RandomPadFixedAR(
                    patch_aspect_ratio=img_width / img_height,
                    labels_format=self.gt_format,
                )
            )
        elif data_generator_mode != "resize":
            raise ValueError(
                f"`data_generator_mode` must be 'resize' or 'pad', got {data_generator_mode!r}."
            )
        resize = Resize(height=img_height, width=img_width, labels_format=self.gt_format)
        transformations.append(resize)

        # The 'resize' chain keeps a JPEG batch on the card where it can
        # (``DataGenerator._generate_on_card``); the 'pad' chain, any other
        # generator and any other batch take ``generate``'s host chain.
        if data_generator_mode == "resize" and isinstance(self.data_generator, DataGenerator):
            generate = functools.partial(self.data_generator._generate_on_card, resize)
        else:
            generate = self.data_generator.generate
        generator = generate(
            batch_size=batch_size,
            shuffle=False,
            transformations=transformations,
            label_encoder=None,
            returns=[
                "processed_images",
                "image_ids",
                "evaluation-neutral",
                "inverse_transforms",
                "original_labels",
            ],
            keep_images_without_gt=True,
            degenerate_box_handling="remove",
        )

        if self.data_generator.image_ids is None:
            self.data_generator.image_ids = list(range(self.data_generator.get_dataset_size()))

        results = [[] for _ in range(self.n_classes + 1)]
        n_images = self.data_generator.get_dataset_size()
        n_batches = int(ceil(n_images / batch_size))
        device_decoded = self.model_mode == "training" and device_decode
        # Decoded detections are small, so in-flight depth is bounded only
        # for the path that keeps the raw (B, #boxes, C+12) tensor.
        max_in_flight = 64 if device_decoded else 4
        pending = deque()

        def dispatch(batch_X):
            with torch.no_grad():
                y_pred = self.model(upload_batch(batch_X, self.device))
                if device_decoded:
                    y_pred = decode_detections_fixed(
                        torch.as_tensor(y_pred, device=self.device),
                        confidence_thresh=decoding_confidence_thresh,
                        iou_threshold=decoding_iou_threshold,
                        top_k=decoding_top_k,
                        input_coords=decoding_pred_coords,
                        normalize_coords=decoding_normalize_coords,
                        img_height=img_height,
                        img_width=img_width,
                        border_pixels=decoding_border_pixels,
                        compact_pool=decoding_compact_pool,
                    )
            return HostCopy(y_pred)

        def drain_one():
            batch, y_host, batch_image_ids, batch_inverse_transforms = pending.popleft()
            with span("eval.drain", id=batch):
                drain(y_host, batch_image_ids, batch_inverse_transforms)

        def drain(y_host, batch_image_ids, batch_inverse_transforms):
            with span("eval.read"):
                y_pred = y_host.numpy()
            if self.model_mode == "training" and not device_decode:
                y_pred = decode_detections(
                    y_pred,
                    confidence_thresh=decoding_confidence_thresh,
                    iou_threshold=decoding_iou_threshold,
                    top_k=decoding_top_k,
                    input_coords=decoding_pred_coords,
                    normalize_coords=decoding_normalize_coords,
                    img_height=img_height,
                    img_width=img_width,
                    border_pixels=decoding_border_pixels,
                )
            else:
                # Decoded on the device: drop all-zero padding rows.
                y_pred = [item[item[:, 0] != 0] for item in y_pred]
            with span("eval.bucket"):
                bucket(apply_inverse_transforms(y_pred, batch_inverse_transforms),
                       batch_image_ids)

        def bucket(y_pred, batch_image_ids):
            count("eval.detections", sum(len(item) for item in y_pred))
            for k, batch_item in enumerate(y_pred):
                image_id = batch_image_ids[k]
                for box in batch_item:
                    confidence = box[pf["conf"]]
                    if round_confidences:
                        confidence = round(confidence, round_confidences)
                    results[int(box[pf["class_id"]])].append(
                        (
                            image_id,
                            confidence,
                            round(float(box[pf["xmin"]]), 1),
                            round(float(box[pf["ymin"]]), 1),
                            round(float(box[pf["xmax"]]), 1),
                            round(float(box[pf["ymax"]]), 1),
                        )
                    )

        for batch in _batches(n_batches, verbose, "Producing predictions batch-wise"):
            with span("data.batch", id=batch):
                (batch_X, batch_image_ids, batch_eval_neutral,
                 batch_inverse_transforms, batch_orig_labels) = next(generator)
            with span("eval.dispatch", id=batch):
                y_host = dispatch(batch_X)
            count("eval.images", len(batch_X))
            pending.append((batch, y_host, batch_image_ids, batch_inverse_transforms))
            if len(pending) >= max_in_flight:
                drain_one()
        while pending:
            drain_one()

        self.prediction_results = results
        if ret:
            return results

    def write_predictions_to_txt(
        self, classes=None, out_file_prefix="comp3_det_test_", verbose=True
    ):
        """Write per-class VOC-format results files (submission format)."""
        if self.prediction_results is None:
            raise ValueError("Run `predict_on_dataset()` first.")
        for class_id in range(1, self.n_classes + 1):
            suffix = f"{class_id:04d}" if classes is None else classes[class_id]
            with open(f"{out_file_prefix}{suffix}.txt", "w") as f:
                for prediction in self.prediction_results[class_id]:
                    row = list(prediction)
                    try:
                        # VOC submission format: 6-digit numeric image ids
                        # (average_precision_evaluator.py:467). Non-numeric
                        # ids (custom datasets) are written verbatim.
                        row[0] = f"{int(row[0]):06d}"
                    except (TypeError, ValueError):
                        row[0] = str(row[0])
                    row[1] = round(row[1], 4)
                    f.write(" ".join(map(str, row)) + "\n")

    @spanned("eval.num_gt")
    def get_num_gt_per_class(self, ignore_neutral_boxes=True, verbose=True, ret=False):
        """Count non-neutral GT boxes per class across the dataset."""
        if self.data_generator.labels is None:
            raise ValueError("No ground truth available.")
        counts = np.zeros(self.n_classes + 1, dtype=np.int64)
        ci = self.gt_format["class_id"]
        neutral = self.data_generator.eval_neutral
        for i, boxes in enumerate(self.data_generator.labels):
            boxes = np.asarray(boxes)
            for j in range(boxes.shape[0]):
                if ignore_neutral_boxes and neutral is not None and neutral[i][j]:
                    continue
                counts[int(boxes[j, ci])] += 1
        self.num_gt_per_class = counts
        if ret:
            return counts

    def match_predictions(
        self,
        ignore_neutral_boxes=True,
        matching_iou_threshold=0.5,
        border_pixels="include",
        sorting_algorithm="quicksort",
        verbose=True,
        ret=False,
    ):
        """Greedy conf-descending matching of predictions to ground truth.

        A prediction is a TP if its best-IoU same-class GT box (within the
        same image) clears the threshold and wasn't already claimed; repeat
        detections of a claimed GT are FPs; matches to eval-neutral boxes are
        skipped entirely (neither TP nor FP). Runs in the host C++.
        """
        return self._match(self._match_class_native, ignore_neutral_boxes,
                           matching_iou_threshold, border_pixels, sorting_algorithm, ret)

    def match_predictions_numpy(
        self,
        ignore_neutral_boxes=True,
        matching_iou_threshold=0.5,
        border_pixels="include",
        sorting_algorithm="quicksort",
        verbose=True,
        ret=False,
    ):
        """:meth:`match_predictions` through the NumPy loop (f64 IoU): the
        plain version of the host C++, as the JAX package runs it without
        its native library."""
        return self._match(self._match_class_numpy, ignore_neutral_boxes,
                           matching_iou_threshold, border_pixels, sorting_algorithm, ret)

    @spanned("eval.match")
    def _match(self, match_class, ignore_neutral_boxes, matching_iou_threshold, border_pixels,
               sorting_algorithm, ret):
        if self.prediction_results is None:
            raise ValueError("Run `predict_on_dataset()` first.")
        if self.data_generator.labels is None:
            raise ValueError("Matching predictions requires ground truth.")
        true_positives = [[]]
        false_positives = [[]]
        cumulative_true_positives = [[]]
        cumulative_false_positives = [[]]
        for class_id in range(1, self.n_classes + 1):
            predictions = self.prediction_results[class_id]
            if len(predictions) == 0:
                true_positives.append(np.zeros(0, dtype=np.int64))
                false_positives.append(np.zeros(0, dtype=np.int64))
                cumulative_true_positives.append(np.array([]))
                cumulative_false_positives.append(np.array([]))
                continue
            true_pos, false_pos = match_class(
                class_id, predictions, ignore_neutral_boxes, matching_iou_threshold,
                border_pixels, sorting_algorithm)
            true_positives.append(true_pos)
            false_positives.append(false_pos)
            cumulative_true_positives.append(np.cumsum(true_pos))
            cumulative_false_positives.append(np.cumsum(false_pos))

        self.true_positives = true_positives
        self.false_positives = false_positives
        self.cumulative_true_positives = cumulative_true_positives
        self.cumulative_false_positives = cumulative_false_positives
        if ret:
            return (true_positives, false_positives,
                    cumulative_true_positives, cumulative_false_positives)

    def _match_class_native(self, class_id, predictions, ignore_neutral_boxes,
                            matching_iou_threshold, border_pixels, sorting_algorithm):
        gi = self.gt_format
        class_id_gt = gi["class_id"]
        box_cols = [gi["xmin"], gi["ymin"], gi["xmax"], gi["ymax"]]
        gen = self.data_generator
        track_neutral = ignore_neutral_boxes and gen.eval_neutral is not None
        image_index = {str(image_id): i for i, image_id in enumerate(gen.image_ids)}

        confs = np.array([p[1] for p in predictions], dtype=np.float32)
        order = np.argsort(-confs, kind=sorting_algorithm)
        pred_img = np.array([image_index[str(predictions[i][0])] for i in order], dtype=np.int32)
        pred_boxes = np.array([predictions[i][2:6] for i in order], dtype=np.float32)
        # Class-filtered GT per image, flattened with prefix offsets.
        gt_box_chunks, neutral_chunks, offsets = [], [], [0]
        for i in range(len(gen.image_ids)):
            labels = np.asarray(gen.labels[i])
            if labels.size == 0:
                offsets.append(offsets[-1])
                continue
            mask = labels[:, class_id_gt] == class_id
            gt_box_chunks.append(labels[mask][:, box_cols].astype(np.float32))
            if track_neutral:
                neutral_chunks.append(np.asarray(gen.eval_neutral[i])[mask])
            offsets.append(offsets[-1] + int(mask.sum()))
        gt_boxes = (np.concatenate(gt_box_chunks, axis=0) if gt_box_chunks
                    else np.zeros((0, 4), np.float32))
        gt_neutral = (np.concatenate(neutral_chunks).astype(np.uint8)
                      if track_neutral and neutral_chunks else None)
        tp_u8, fp_u8 = native.match_predictions_class(
            pred_img, pred_boxes, np.asarray(offsets, np.int32), gt_boxes, gt_neutral,
            matching_iou_threshold, box_ops.border_delta(border_pixels),
        )
        return tp_u8.astype(np.int64), fp_u8.astype(np.int64)

    def _match_class_numpy(self, class_id, predictions, ignore_neutral_boxes,
                           matching_iou_threshold, border_pixels, sorting_algorithm):
        gi = self.gt_format
        class_id_gt = gi["class_id"]
        box_cols = [gi["xmin"], gi["ymin"], gi["xmax"], gi["ymax"]]
        gen = self.data_generator
        neutral_available = gen.eval_neutral is not None
        ground_truth = {}
        for i, image_id in enumerate(gen.image_ids):
            labels = np.asarray(gen.labels[i])
            if ignore_neutral_boxes and neutral_available:
                ground_truth[str(image_id)] = (labels, np.asarray(gen.eval_neutral[i]))
            else:
                ground_truth[str(image_id)] = labels

        true_pos = np.zeros(len(predictions), dtype=np.int64)
        false_pos = np.zeros(len(predictions), dtype=np.int64)
        image_ids = np.array([str(p[0]) for p in predictions])
        confs = np.array([p[1] for p in predictions], dtype=np.float32)
        boxes = np.array([p[2:6] for p in predictions], dtype=np.float32)
        order = np.argsort(-confs, kind=sorting_algorithm)

        gt_matched = {}
        for rank, idx in enumerate(order):
            image_id = image_ids[idx]
            pred_box = boxes[idx]
            entry = ground_truth[image_id]
            if ignore_neutral_boxes and neutral_available:
                gt, eval_neutral = entry
            else:
                gt, eval_neutral = entry, None
            gt = np.asarray(gt)
            if gt.size == 0:
                false_pos[rank] = 1
                continue
            class_mask = gt[:, class_id_gt] == class_id
            gt_c = gt[class_mask]
            if eval_neutral is not None:
                neutral_c = eval_neutral[class_mask]
            if gt_c.size == 0:
                false_pos[rank] = 1
                continue
            overlaps = box_ops.iou_np(
                gt_c[:, box_cols], pred_box, coords="corners", mode="element-wise",
                border_pixels=border_pixels,
            )
            match = int(np.argmax(overlaps))
            if overlaps[match] < matching_iou_threshold:
                false_pos[rank] = 1
                continue
            if eval_neutral is not None and bool(neutral_c[match]):
                continue  # neutral GT: neither TP nor FP
            claimed = gt_matched.setdefault(image_id, np.zeros(gt_c.shape[0], dtype=bool))
            if not claimed[match]:
                true_pos[rank] = 1
                claimed[match] = True
            else:
                false_pos[rank] = 1  # duplicate detection
        return true_pos, false_pos

    @spanned("eval.precision_recall")
    def compute_precision_recall(self, verbose=True, ret=False):
        if self.cumulative_true_positives is None:
            raise ValueError("Run `match_predictions()` first.")
        if self.num_gt_per_class is None:
            raise ValueError("Run `get_num_gt_per_class()` first.")
        cumulative_precisions = [[]]
        cumulative_recalls = [[]]
        for class_id in range(1, self.n_classes + 1):
            tp = np.asarray(self.cumulative_true_positives[class_id], dtype=np.float64)
            fp = np.asarray(self.cumulative_false_positives[class_id], dtype=np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                precision = np.where(tp + fp > 0, tp / (tp + fp), 0)
            n_gt = self.num_gt_per_class[class_id]
            recall = tp / n_gt if n_gt > 0 else np.zeros_like(tp)
            cumulative_precisions.append(precision)
            cumulative_recalls.append(recall)
        self.cumulative_precisions = cumulative_precisions
        self.cumulative_recalls = cumulative_recalls
        if ret:
            return cumulative_precisions, cumulative_recalls

    @spanned("eval.ap")
    def compute_average_precisions(
        self, mode="sample", num_recall_points=11, verbose=True, ret=False
    ):
        if self.cumulative_precisions is None:
            raise ValueError("Run `compute_precision_recall()` first.")
        if mode not in ("sample", "integrate"):
            raise ValueError("`mode` must be 'sample' or 'integrate'.")
        average_precisions = [0.0]
        for class_id in range(1, self.n_classes + 1):
            precision = np.asarray(self.cumulative_precisions[class_id])
            recall = np.asarray(self.cumulative_recalls[class_id])
            ap = 0.0
            if precision.size == 0:
                average_precisions.append(ap)
                continue
            if mode == "sample":
                for t in np.linspace(0, 1, num_recall_points, endpoint=True):
                    eligible = precision[recall >= t]
                    ap += float(np.amax(eligible)) if eligible.size else 0.0
                ap /= num_recall_points
            else:  # integrate: reverse-scan running max over unique recalls
                unique_recalls, unique_indices = np.unique(recall, return_index=True)
                maximal_precisions = np.zeros_like(unique_recalls)
                recall_deltas = np.zeros_like(unique_recalls)
                for i in range(len(unique_recalls) - 2, -1, -1):
                    begin, end = unique_indices[i], unique_indices[i + 1]
                    maximal_precisions[i] = max(
                        np.amax(precision[begin:end]), maximal_precisions[i + 1]
                    )
                    recall_deltas[i] = unique_recalls[i + 1] - unique_recalls[i]
                ap = float(np.sum(maximal_precisions * recall_deltas))
            average_precisions.append(ap)
        self.average_precisions = average_precisions
        if ret:
            return average_precisions

    @spanned("eval.map")
    def compute_mean_average_precision(self, ret=True):
        if self.average_precisions is None:
            raise ValueError("Run `compute_average_precisions()` first.")
        self.mean_average_precision = float(np.average(self.average_precisions[1:]))
        if ret:
            return self.mean_average_precision
