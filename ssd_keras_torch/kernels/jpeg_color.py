"""libjpeg's chroma upsampling and YCbCr -> RGB conversion: the CUDA kernel
``csrc/jpeg_color.cu`` and its wrapper.

The card's JPEG decoder (``native/jpeg.py``) has nvJPEG decode a batch to
its planes and hands them here, so that the pixels are libjpeg's (PIL's,
the JAX package's) up to nvJPEG's IDCT, which is within a level of
libjpeg's. Not the port of a TPU kernel: the JAX package runs this stage
inside libjpeg on its host (``ssd_keras_tpu/native/ssd_jpeg.cpp``).

What bounds it on the card: the bytes (each plane read once, the pixels
written once); one launch a batch, one grid row an image.

Dispatch is by the tensors' device and nothing else: CPU tensors go to the
plain PyTorch version (``ops/jpeg_color.py:ycc_to_rgb``); CUDA tensors
launch the kernel or raise. ``launches`` counts the calls that launched it.
"""

from __future__ import annotations

import torch

from ssd_keras_torch.kernels.build import load_library
from ssd_keras_torch.ops import jpeg_color

__all__ = ["launches", "ycc_to_rgb"]

# Incremented once per call that launches the kernel (never for the CPU
# path): a run can show that its JPEG batches went through the kernel.
launches = 0

# One grid row an image (CUDA's limit on gridDim.y).
MAX_IMAGES = 65535


def ycc_to_rgb(planes: torch.Tensor, layout: torch.Tensor, out_bytes: int) -> torch.Tensor:
    """The batch's pixels, a flat uint8 tensor of ``out_bytes`` on
    ``planes``' device (see ``ops/jpeg_color.py`` for ``layout``, a CPU
    int64 (n, 9) tensor). On the card: one kernel launch on the current
    stream, counted in ``launches``; the layout goes up from pinned memory
    without a wait."""
    global launches
    if planes.dtype != torch.uint8 or planes.dim() != 1 or not planes.is_contiguous():
        raise ValueError(f"planes must be a contiguous 1-D uint8 tensor, got {planes.dtype} "
                         f"{tuple(planes.shape)}")
    if planes.device.type == "cpu":
        return jpeg_color.ycc_to_rgb(planes, layout, out_bytes)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    rows = jpeg_color.check_layout(layout, planes.numel(), out_bytes)
    if len(rows) > MAX_IMAGES:
        raise ValueError(f"{len(rows)} images exceed the kernel's {MAX_IMAGES}")
    out = torch.empty(out_bytes, dtype=torch.uint8, device=planes.device)
    if len(rows) == 0:
        return out
    index = planes.device.index
    device_layout = layout.contiguous().pin_memory().to(planes.device, non_blocking=True)
    max_pixels = int((rows[:, 5] * rows[:, 6]).max())
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        status = load_library().ssd_jpeg_ycc_to_rgb(
            planes.data_ptr(), device_layout.data_ptr(), out.data_ptr(), len(rows), max_pixels,
            stream)
    if status != 0:
        raise RuntimeError(f"ssd_jpeg_ycc_to_rgb launch failed: CUDA error {status}")
    launches += 1
    return out
