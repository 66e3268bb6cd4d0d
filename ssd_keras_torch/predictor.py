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

Each input shape gets its own program, kept in an LRU cache of
``max_compiled_shapes`` entries as the JAX predictor keeps one compiled
program per shape. On the card an entry is a CUDA graph of the cast, the
resize, the forward, the decode and the NMS kernel over a static input and
output, so a chunk costs one copy in, one graph launch and one copy out on
the host instead of some hundred kernel launches. On the CPU an entry is
the eager forward.

Each call is a span ``predict`` (its id the predictor's call number) over
the host stages ``predict.prepare``, ``predict.weights_check``,
``predict.capture`` (a graph made), ``predict.stack``, ``predict.pin``,
``predict.launch``, ``predict.read`` and ``predict.finish``
(``utils.profiling``); the counters ``predict.requests``,
``predict.images``, ``predict.slots`` (chunks times the batch size),
``predict.graph_captures`` and ``predict.graph_drops`` count its work, and
each graph replay makes again the counts its capture held
(``utils/cuda_graph.py``): the decoder's ``decode.lanes``, the NMS
kernel's and the convolutions' epilogues' launches.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssd_keras_torch.data.photometric import ConvertTo3Channels
from ssd_keras_torch.utils.cuda_graph import CapturedGraph
from ssd_keras_torch.utils.profiling import count, span

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
      max_compiled_shapes: each distinct (height, width, dtype) input shape
        keeps its own program (a CUDA graph on the card, with a private
        memory pool: 0.32-0.37 GB for SSD300 at batch 8 in bf16 on an
        H100); beyond this many shapes the least recently used is dropped,
        and made again if that shape comes back.

    The graphs read the model's weights where they were when captured: an
    optimizer step, ``load_state_dict`` or ``.to()`` moves a parameter's
    ``_version`` or ``data_ptr``, and the next ``predict`` drops every graph
    first. A write through ``param.data`` moves neither and is not seen.
    """

    def __init__(self, model: nn.Module, batch_size: int = 8,
                 confidence_thresh: float = 0.0, resize_on_device: bool = True,
                 max_compiled_shapes: int = 16):
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
        # One resize+forward program per (in_h, in_w, dtype), LRU-bounded.
        self._compiled: "OrderedDict[Tuple, Callable]" = OrderedDict()
        self._max_compiled = max(1, int(max_compiled_shapes))
        self._weights = None  # the parameters' stamp the entries were made with
        self._stream = None
        self._calls = 0

    def _pinned(self, batch: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(batch)
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host

    @torch.inference_mode()
    def _run(self, images: torch.Tensor) -> torch.Tensor:
        h, w = self._model_hw
        if tuple(images.shape[1:3]) == (h, w):
            x = images.float()
        else:
            x = device_resize_batch(images, h, w)
        return self.model(x)

    def _eager(self, host: torch.Tensor) -> torch.Tensor:
        """The uncached path: upload, then the forward op by op."""
        return self._run(host.to(self.device, non_blocking=True))

    def _capture_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _capture(self, ih: int, iw: int, dtype: torch.dtype) -> CapturedGraph:
        """One input shape's cast to f32, resize, forward, decode and NMS
        kernel as a CUDA graph over a static (batch, ih, iw, 3) input and a
        static (batch, top_k, 6) output. The graph keeps the model's
        ``graph_inputs``; the predictor drops its graphs when a parameter
        changes (``_drop_stale``)."""
        with torch.inference_mode():
            static_in = torch.zeros((self.batch_size, ih, iw, 3), dtype=dtype,
                                    device=self.device)
        return CapturedGraph(self._run, static_in, self._capture_stream(),
                             lambda: self.model.graph_inputs(self.device))

    def _drop_stale(self) -> None:
        """Drop every entry if a parameter or buffer changed since they were
        made (the graphs hold their old addresses and cast copies)."""
        stamp = tuple((t._version, t.data_ptr())
                      for t in itertools.chain(self.model.parameters(), self.model.buffers()))
        if stamp != self._weights:
            if self._compiled and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # no dropped graph still runs
            count("predict.graph_drops", len(self._compiled))
            self._compiled.clear()
            self._weights = stamp

    def _fused_run(self, ih: int, iw: int, dtype) -> Callable[[torch.Tensor], torch.Tensor]:
        """The program for (ih, iw, dtype) inputs, made at its first use: a
        CUDA graph on the card, the eager forward on the CPU. It maps a
        host batch to the device output."""
        key = (ih, iw, np.dtype(dtype).str)
        run = self._compiled.get(key)
        if run is not None:
            self._compiled.move_to_end(key)
            return run
        if self.device.type == "cuda":
            with span("predict.capture"):
                run = self._capture(ih, iw, torch.from_numpy(np.empty(0, dtype)).dtype)
            count("predict.graph_captures")
        else:
            run = self._eager
        self._compiled[key] = run
        while len(self._compiled) > self._max_compiled:
            self._compiled.popitem(last=False)
            count("predict.graph_drops")
        return run

    @staticmethod
    def _read(out: torch.Tensor) -> np.ndarray:
        """A chunk's detections on the host: the one wait for the device."""
        return out.cpu().numpy()

    def predict(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Detections per image: rows ``[class_id, conf, xmin, ymin, xmax, ymax]``
        in each input image's own pixel coordinates, zero rows removed."""
        self._calls += 1
        count("predict.requests")
        count("predict.images", len(images))
        with span("predict", id=self._calls):
            return self._predict(images)

    def _predict(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        h, w = self._model_hw
        scales = []
        groups: Dict[Tuple, Tuple[List[int], List[np.ndarray]]] = {}
        with span("predict.prepare"):
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

        with span("predict.weights_check"):
            self._drop_stale()
        outputs: List[np.ndarray] = [None] * len(images)
        for (ih, iw, _), (idxs, arrs) in groups.items():
            run = self._fused_run(ih, iw, arrs[0].dtype)
            # The upload and forward of chunk N+1 are queued on the device
            # while chunk N's detections come back; at most two in flight.
            pending = deque()  # (chunk_start, n_valid, device_out)

            def drain_one():
                start, n, out = pending.popleft()
                with span("predict.read"):
                    dets = self._read(out)
                for j in range(n):
                    outputs[idxs[start + j]] = dets[j]

            for start in range(0, len(arrs), self.batch_size):
                with span("predict.stack"):
                    chunk = arrs[start : start + self.batch_size]
                    n = len(chunk)
                    if n < self.batch_size:  # pad to the batch size
                        chunk = chunk + [np.zeros_like(chunk[0])] * (self.batch_size - n)
                    batch = np.stack(chunk)
                with span("predict.pin"):
                    host = self._pinned(batch)
                with span("predict.launch"):
                    pending.append((start, n, run(host)))
                count("predict.slots", self.batch_size)
                if len(pending) > 2:
                    drain_one()
            while pending:
                drain_one()

        with span("predict.finish"):
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
