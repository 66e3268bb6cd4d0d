"""High-level serving API: images in, detections in original coordinates out.

Port of ``ssd_keras_tpu/predictor.py``. :class:`SSDPredictor` takes images of
any size, uploads them as uint8 from pinned memory, resizes them on the
model's device (bilinear with antialiasing, the triangle filter PIL's
``Image.BILINEAR`` uses), runs an ``inference`` or ``inference_fast`` model,
and maps the detections back to each image's own pixel frame. Grayscale,
gray-alpha and RGBA inputs are made RGB first, as PIL's ``convert("RGB")``
makes them (gray planes repeated, alpha dropped), and then take the same
path. With ``resize_on_device=False`` the host resizes instead, with
:func:`resize_bilinear_pil`, PIL's ``Image.BILINEAR`` in NumPy. No PIL is
needed. Requests are chunked and padded to the predictor's batch size.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssd_keras_torch.data.photometric import ConvertTo3Channels

__all__ = ["SSDPredictor", "device_resize_batch", "resize_bilinear_pil", "to_rgb"]

_PRECISION_BITS = 22  # PIL's fixed-point precision for 8-bit resampling


def _pil_bilinear_taps(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    bilinear (triangle) filter: a (out_size, in_size) int64 matrix of
    22-bit weights."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    weights = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax) + xmin
        k = np.maximum(1.0 - np.abs((x - center + 0.5) * (1.0 / filterscale)), 0.0)
        total = 0.0
        for w in k:  # in order, as PIL sums
            total += w
        if total != 0.0:
            k = k / total
        fixed = k * (1 << _PRECISION_BITS)
        weights[xx, xmin:xmin + xmax] = np.where(k < 0, -0.5 + fixed, 0.5 + fixed).astype(np.int64)
    return weights


def _pil_pass(image: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    """One 8-bit resampling pass of PIL along ``axis`` (0 rows, 1 columns)."""
    # Integer sums below 2**53: exact as a float64 matrix product.
    moved = np.moveaxis(image.astype(np.float64), axis, -1)
    acc = (moved @ weights.T.astype(np.float64)).astype(np.int64) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def resize_bilinear_pil(image: np.ndarray, out_height: int, out_width: int) -> np.ndarray:
    """``Image.fromarray(image).resize((out_width, out_height),
    Image.BILINEAR)`` for a uint8 (H, W, C) image, in NumPy: a triangle
    filter whose support grows with the reduction factor, PIL's 22-bit
    fixed-point weights, and a horizontal pass then a vertical one, each
    rounded to uint8."""
    image = np.asarray(image, np.uint8)
    h, w = image.shape[:2]
    if w != out_width:
        image = _pil_pass(image, _pil_bilinear_taps(w, out_width), 1)
    if h != out_height:
        image = _pil_pass(image, _pil_bilinear_taps(h, out_height), 0)
    return image.copy()


def to_rgb(image: np.ndarray) -> np.ndarray:
    """A uint8 image as (H, W, 3), as PIL's ``convert("RGB")`` makes it from
    the ``L``, ``LA`` and ``RGBA`` arrays ``Image.fromarray`` reads: gray
    planes repeated, alpha dropped."""
    image = np.asarray(image, np.uint8)
    if image.ndim == 3 and image.shape[2] == 2:
        image = image[..., 0]
    return ConvertTo3Channels()(image)


def device_resize_batch(images: torch.Tensor, out_height: int, out_width: int) -> torch.Tensor:
    """Bilinear-resize a (B, H, W, 3) batch to (B, out_h, out_w, 3) float32.

    ``F.interpolate(mode='bilinear', antialias=True, align_corners=False)``,
    the counterpart of ``jax.image.resize(..., 'linear', antialias=True)``.
    """
    x = images.float().permute(0, 3, 1, 2)
    x = F.interpolate(
        x, size=(out_height, out_width), mode="bilinear", antialias=True,
        align_corners=False,
    )
    return x.permute(0, 2, 3, 1)


class SSDPredictor:
    """Batched end-to-end SSD inference on the model's device.

    Args:
      model: an 'inference' or 'inference_fast' model (``ssd_300`` output).
      batch_size: requests are chunked and padded to this batch size.
      confidence_thresh: post-filter on returned rows (the model's decode
        already applied its configured threshold, NMS and top-k).
      resize_on_device: resize on the model's device (default). ``False``
        resizes every non-model-size input on the host with
        :func:`resize_bilinear_pil`.
    """

    def __init__(self, model: nn.Module, batch_size: int = 8,
                 confidence_thresh: float = 0.0, resize_on_device: bool = True):
        if model.mode == "training":
            raise ValueError(
                "SSDPredictor needs an 'inference' or 'inference_fast' model."
            )
        self.model = model
        self.config = model.config
        self.device = next(model.parameters()).device
        self.batch_size = int(batch_size)
        self.confidence_thresh = confidence_thresh
        self.resize_on_device = resize_on_device
        self._model_hw = (self.config.img_height, self.config.img_width)

    def _upload(self, batch: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(batch)
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def _run(self, images: torch.Tensor) -> torch.Tensor:
        h, w = self._model_hw
        if tuple(images.shape[1:3]) == (h, w):
            x = images.float()
        else:
            x = device_resize_batch(images, h, w)
        return self.model(x)

    def predict(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Detections per image: rows ``[class_id, conf, xmin, ymin, xmax, ymax]``
        in each input image's own pixel coordinates, zero rows removed."""
        h, w = self._model_hw
        scales = []
        groups: Dict[Tuple, Tuple[List[int], List[np.ndarray]]] = {}
        for i, image in enumerate(images):
            image = np.asarray(image)
            ih, iw = image.shape[:2]
            scales.append((iw / w, ih / h))
            if not (image.ndim == 3 and image.shape[2] == 3):
                image = to_rgb(image)
            if not self.resize_on_device and (ih, iw) != (h, w):
                image = resize_bilinear_pil(image, h, w).astype(np.float32)
                ih, iw = h, w
            idxs, arrs = groups.setdefault((ih, iw, image.dtype.str), ([], []))
            idxs.append(i)
            arrs.append(image)

        outputs: List[np.ndarray] = [None] * len(images)
        for idxs, arrs in groups.values():
            # The upload and forward of chunk N+1 are queued on the device
            # while chunk N's detections come back; at most two in flight.
            pending = deque()  # (chunk_start, n_valid, device_out)

            def drain_one():
                start, n, out = pending.popleft()
                dets = out.cpu().numpy()
                for j in range(n):
                    outputs[idxs[start + j]] = dets[j]

            for start in range(0, len(arrs), self.batch_size):
                chunk = arrs[start : start + self.batch_size]
                n = len(chunk)
                if n < self.batch_size:  # pad to the batch size
                    chunk = chunk + [np.zeros_like(chunk[0])] * (self.batch_size - n)
                pending.append((start, n, self._run(self._upload(np.stack(chunk)))))
                if len(pending) > 2:
                    drain_one()
            while pending:
                drain_one()

        results = []
        for dets, (sx, sy) in zip(outputs, scales):
            keep = (dets[:, 0] != 0) & (dets[:, 1] > self.confidence_thresh)
            dets = dets[keep].copy()
            dets[:, [2, 4]] *= sx
            dets[:, [3, 5]] *= sy
            results.append(dets)
        return results

    def __call__(self, images):
        return self.predict(images)
