"""The hand-written CUDA kernels, built by nvcc at first use (``build``).

``greedy_nms_mask_batched`` is the NMS kernel's wrapper; ``nms`` stays the
submodule."""

from ssd_keras_torch.kernels.nms import greedy_nms_mask_batched

__all__ = ["greedy_nms_mask_batched"]
