"""Greedy-NMS keep mask: the CUDA kernel ``csrc/nms.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``ssd_keras_tpu/kernels/nms_pallas.py:
_nms_kernel`` (and its wrapper ``_greedy_nms_mask_batched_local``), which
the fixed-shape decoder runs over L = B * (C - 1) lanes of K = 400
candidates per batch in ``inference`` mode and L = B lanes in
``inference_fast``.

What bounds it on the card: the IoU tests, up to K (K - 1) / 2 a lane with
an IEEE division each, and the serial chain of keep decisions around them.
The kernel runs in two passes (see the source's header): pass A tests
every pair below the lane's trip bound in parallel and packs the results
into an (L, K, ceil(K / 64)) u64 bitmask; pass B resolves each lane with
one warp, serially in bit operations only.

Dispatch is by the tensors' device and nothing else: a CPU tensor goes to
the plain PyTorch version (``ops/nms.py:greedy_nms_mask``); a CUDA tensor
launches the kernel or raises. The counter ``nms.launches``
(``utils.profiling.count``) counts the calls that launched the kernel (each
is two kernel launches, pass A then pass B).

The decode calls this once a batch and is host-bound on sparse lanes, so a
call does little on the host besides its two launches: it allocates only
``keep``; pass A's scratch is kept per (device, stream) and grown to the
largest call seen (3.6 MB at L = 160, K = 400; 57 MB at L = 2560), and
the device is switched only when it is not the current one.

Under CUDA-graph capture (the predictor's per-shape graphs) a call launches
nothing: it records its two kernels into the graph and takes a scratch of
its own from the graph's private pool, which no eager call reuses. Its count
is held by the capture and made at each replay (``utils/cuda_graph.py``).
"""

from __future__ import annotations

import torch

from ssd_keras_torch.kernels.build import launch, raw_stream
from ssd_keras_torch.ops.nms import greedy_nms_mask, mask_words
from ssd_keras_torch.utils.profiling import count, span

__all__ = ["greedy_nms_mask_batched", "iou_mask"]

# Pass B keeps each lane's removed bitmap, ceil(K / 64) words, in static
# shared memory sized for 160 words (csrc/nms.cu:kMaxWords).
MAX_CANDIDATES = 10240


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(
            f"boxes must be float32 and valid bool, got {boxes.dtype} and {valid.dtype}"
        )
    if boxes.dim() != 3 or boxes.shape[2] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(
            f"expected boxes (L, K, 4) and valid (L, K), got {tuple(boxes.shape)} "
            f"and {tuple(valid.shape)}"
        )
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    if boxes.device != valid.device:
        raise ValueError(f"boxes on {boxes.device} but valid on {valid.device}")


def _check_cuda(boxes: torch.Tensor) -> None:
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if boxes.shape[1] > MAX_CANDIDATES:
        raise ValueError(
            f"K = {boxes.shape[1]} exceeds the kernel's {MAX_CANDIDATES} candidates"
        )


# Pass A's scratch for each (device index, raw stream). A call's two kernels
# run on its stream after every earlier call's, so the next call on the same
# stream may reuse the words; pass B reads only the words pass A writes in
# its own call, so what an earlier call left there does not matter.
_scratches: dict = {}


def _scratch(index: int, stream: int, words: int) -> torch.Tensor:
    """At least ``words`` int64 of scratch on card ``index`` for ``stream``."""
    scratch = _scratches.get((index, stream))
    if scratch is None or scratch.numel() < words:
        scratch = torch.empty(words, dtype=torch.int64, device=torch.device("cuda", index))
        _scratches[index, stream] = scratch
    return scratch


def _graph_scratch(device: torch.device, words: int) -> torch.Tensor:
    """Scratch for a call under CUDA-graph capture: allocated from the
    graph's private pool, so it belongs to that graph alone (an eager call
    on the capture stream keeps using ``_scratches``)."""
    return torch.empty(words, dtype=torch.int64, device=device)


def greedy_nms_mask_batched(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float = 0.45,
    border_delta: float = 0.0,
) -> torch.Tensor:
    """(L, K) bool keep mask for (L, K, 4) f32 corners sorted by score
    descending per lane and an (L, K) bool ``valid`` mask. On the card one
    call is two kernel launches (pass A, pass B) and counts once in
    ``nms.launches``."""
    _check(boxes, valid)
    if boxes.device.type == "cpu":
        return greedy_nms_mask(boxes, valid, iou_threshold, border_delta)
    _check_cuda(boxes)

    lanes, k = valid.shape
    keep = torch.empty_like(valid)
    if lanes == 0 or k == 0:
        return keep
    with span("nms.launch"):
        words = lanes * k * mask_words(k)
        if torch.cuda.is_current_stream_capturing():
            mask = _graph_scratch(boxes.device, words)
        else:
            index = boxes.device.index
            mask = _scratch(index, raw_stream(index), words)
        launch("ssd_greedy_nms", boxes.device, boxes.data_ptr(), valid.data_ptr(),
               keep.data_ptr(), mask.data_ptr(), lanes, k, float(iou_threshold),
               float(border_delta))
    count("nms.launches")
    return keep


def iou_mask(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float = 0.45,
    border_delta: float = 0.0,
) -> torch.Tensor:
    """Pass A alone, on CUDA tensors: the (L, K, ceil(K / 64)) int64
    suppression bitmask that ``ops/nms.py:iou_suppression_mask`` computes
    in plain PyTorch. Only the words pass B reads are written (rows below
    the lane's trip bound, words from the row's own 64-row chunk up to the
    bound's); the rest are left as ``torch.empty`` gave them. Not counted in
    ``nms.launches``: the main path does not call it."""
    _check(boxes, valid)
    _check_cuda(boxes)
    lanes, k = valid.shape
    mask = torch.empty(lanes, k, mask_words(k), dtype=torch.int64, device=boxes.device)
    if lanes == 0 or k == 0:
        return mask
    launch("ssd_nms_iou_mask", boxes.device, boxes.data_ptr(), valid.data_ptr(),
           mask.data_ptr(), lanes, k, float(iou_threshold), float(border_delta))
    return mask
