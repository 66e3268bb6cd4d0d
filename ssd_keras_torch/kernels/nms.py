"""Greedy-NMS keep mask: the CUDA kernel ``csrc/nms.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``ssd_keras_tpu/kernels/nms_pallas.py:
_nms_kernel`` (and its wrapper ``_greedy_nms_mask_batched_local``), which
the fixed-shape decoder runs over L = B * (C - 1) lanes of K = 400
candidates per batch in ``inference`` mode and L = B lanes in
``inference_fast``.

What bounds it on the card: the serial chain of K row decisions per lane,
a latency bound; the lanes' data (20 bytes a box) and IoU arithmetic are
small. The kernel runs one thread block per lane with the lane held in
shared memory, stops at the lane's last valid row, and pays a barrier only
for kept rows (see the source's header).

Dispatch is by the tensors' device and nothing else: a CPU tensor goes to
the plain PyTorch version (``ops/nms.py:greedy_nms_mask``); a CUDA tensor
launches the kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ssd_keras_torch.kernels.build import load_library
from ssd_keras_torch.ops.nms import greedy_nms_mask

__all__ = ["greedy_nms_mask_batched", "launches"]

# Incremented once per kernel launch (never for the CPU path): a run can
# show that its NMS went through the kernel.
launches = 0

# Shared memory per lane is 22 bytes a candidate; 227 KB is a block's limit.
MAX_CANDIDATES = 10240


def greedy_nms_mask_batched(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float = 0.45,
    border_delta: float = 0.0,
) -> torch.Tensor:
    """(L, K) bool keep mask for (L, K, 4) f32 corners sorted by score
    descending per lane and an (L, K) bool ``valid`` mask."""
    global launches
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
    if boxes.device.type == "cpu":
        return greedy_nms_mask(boxes, valid, iou_threshold, border_delta)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")

    lanes, k = valid.shape
    if k > MAX_CANDIDATES:
        raise ValueError(f"K = {k} exceeds the kernel's {MAX_CANDIDATES} candidates")
    keep = torch.empty_like(valid)
    if lanes == 0 or k == 0:
        return keep
    lib = load_library()
    with torch.cuda.device(boxes.device):
        status = lib.ssd_greedy_nms(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), lanes, k,
            float(iou_threshold), float(border_delta),
            torch.cuda.current_stream().cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"greedy NMS kernel launch failed: CUDA error {status}")
    launches += 1
    return keep
