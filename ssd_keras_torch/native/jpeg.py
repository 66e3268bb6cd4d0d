"""Batch JPEG decode: nvJPEG on the card, libjpeg on the host.

The port of the JAX package's threaded decoder (``ssd_keras_tpu/native/
__init__.py:decode_jpeg_batch``). One call decodes a list of encoded files
to uint8 arrays of the shapes ``np.array(PIL.Image.open(f))`` gives: (H, W,
3) RGB for 3-component files, (H, W) for grayscale. Files that neither
decoder returns as RGB or gray (CMYK and other 4-component files) are read
one by one through PIL, with PIL's shape ((H, W, 4) for CMYK), as the JAX
package does. EXIF orientation is not applied, as ``Image.open`` does not.

Two backends, chosen by ``device`` and nothing else:

- The card (``device=None``, ``"cuda"`` or ``"cuda:N"``; the default, as
  the port's other entry points): ``nvjpeg_decode.cu`` over the CUDA
  toolkit's nvJPEG, built by ``kernels/build.py:load_nvjpeg_library`` at its
  first use. Each file's header is read with ``nvjpegGetImageInfo``. The
  bitstreams are gathered into one pinned host buffer and one
  ``nvjpegDecodeBatched`` call on the current stream (counted in
  ``nvjpeg.batches``, ``utils.profiling.count``) decodes the batch
  (baseline, progressive and restart-marked files alike) to its planes,
  all in one allocation on the card. Then one launch of the colour kernel
  (``kernels/jpeg_color.py``: libjpeg's fancy upsampling and YCbCr -> RGB in
  libjpeg's integer arithmetic) writes the pixels, and one copy brings them
  back into pinned memory (``decode_packed`` leaves them on the card,
  packed, for the resize kernel, and waits for nothing). Files of another
  subsampling than 4:4:4, 4:2:2 or 4:2:0 go to PIL too. Any nvJPEG error
  raises ``ValueError`` with the file's index and the nvJPEG status;
  nothing falls back to PIL or to the CPU. ``n_threads`` is not used
  there.
- The host (``device="cpu"``): ``ssd_jpeg.cpp``, the JAX package's source,
  built by g++ with ``-ljpeg -lpthread`` only where g++ finds
  ``jpeglib.h``. Where it cannot be built, asking for it raises
  ``RuntimeError`` with the reason. Its output equals the JAX package's
  native decoder bit for bit.

nvJPEG's IDCT is not libjpeg's: its planes differ from libjpeg's by at most
one level, which libjpeg's colour conversion turns into a few levels of RGB
(``ROADMAP.md``, "Differences kept on purpose"; ``chip_smoke.py`` phase 14
holds the card's pixels to PIL's).
"""

from __future__ import annotations

import ctypes
import functools
import io
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ssd_keras_torch.devices import target_device
from ssd_keras_torch.ops import jpeg_color
from ssd_keras_torch.utils.profiling import count

__all__ = ["decode_jpeg_batch", "decode_packed", "decode_planes", "jpeg_available",
           "JPEG_SOURCE"]

JPEG_SOURCE = Path(__file__).resolve().parent / "ssd_jpeg.cpp"
# The header g++ must find for the host decoder to be built.
JPEG_HEADER = "jpeglib.h"
JPEG_LIBRARIES = ("-ljpeg", "-lpthread")

# nvjpegChromaSubsampling_t values the colour kernel takes (4:4:4, 4:2:2,
# 4:2:0, the ones PIL writes), and gray. Files of other subsamplings
# (4:4:0, 4:1:1, 4:1:0), which libjpeg upsamples by other rules, go to PIL.
_CSS_KIND = {0: jpeg_color.KIND_444, 1: jpeg_color.KIND_422, 2: jpeg_color.KIND_420}
_CSS_GRAY = 6
_NVJPEG_STATUS = {
    1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG", 4: "JPEG_NOT_SUPPORTED",
    5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED", 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR",
    9: "IMPLEMENTATION_NOT_SUPPORTED", 10: "INCOMPLETE_BITSTREAM",
}

# One decode at a time: the card's decoder state and the pinned buffers
# below are shared.
_LOCK = threading.Lock()
# Pinned host buffers kept across calls ("bitstreams", "pixels"), grown as
# needed. "pixels": a call waits for its copy before it returns, so the next
# one may reuse it. "bitstreams": a call need not wait for its decode
# (``decode_packed``), so an event recorded on the stream after each
# ``nvjpegDecodeBatched`` (``_DECODING``) is waited on before the buffer is
# staged again; the decoder's own state is ordered by it too.
_PINNED: dict = {}
_DECODING: dict = {}


def _status(code: int) -> str:
    if code >= 1000:
        return f"CUDA error {code - 1000}"
    return f"nvJPEG status {code} ({_NVJPEG_STATUS.get(code, 'unknown')})"


# --------------------------------------------------------------------------- #
# The host decoder (libjpeg)
# --------------------------------------------------------------------------- #


def _has_header(gxx: str, header: str) -> bool:
    proc = subprocess.run([gxx, "-E", "-x", "c++", "-"], input=f"#include <{header}>\n",
                          capture_output=True, text=True, timeout=120)
    return proc.returncode == 0


def _build_libjpeg() -> ctypes.CDLL:
    from ssd_keras_torch import native

    path = native._library_path(JPEG_SOURCE, JPEG_LIBRARIES)
    if not path.exists():
        gxx = native._gxx()
        if not _has_header(gxx, JPEG_HEADER):
            raise RuntimeError(
                f"{JPEG_HEADER} not found by {gxx}: libjpeg's headers are missing, so the "
                "host JPEG decoder of ssd_keras_torch cannot be built (decode on the card "
                "with device='cuda', or read files through PIL).")
        native._build(path, JPEG_SOURCE, JPEG_LIBRARIES)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    ip, p = ctypes.POINTER(ctypes.c_int), ctypes.c_void_p
    lib.ssd_jpeg_dims.restype = ctypes.c_int
    lib.ssd_jpeg_dims.argtypes = [p, ctypes.c_int, ip, ip, ip]
    lib.ssd_decode_jpeg_batch.restype = ctypes.c_int
    lib.ssd_decode_jpeg_batch.argtypes = [p, ip, ctypes.c_int, p, ip, ip, ip, ctypes.c_int, ip]
    return lib


@functools.lru_cache(maxsize=None)
def _libjpeg() -> Tuple[Optional[ctypes.CDLL], str]:
    """The host decoder and ``""``, or None and why it cannot be built (the
    answer is kept: a missing header does not appear later in a process)."""
    try:
        return _build_libjpeg(), ""
    except RuntimeError as e:
        return None, str(e)


def _load_libjpeg() -> ctypes.CDLL:
    lib, why = _libjpeg()
    if lib is None:
        raise RuntimeError(why)
    return lib


def _pil(buffer: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(buffer)) as img:
        return np.array(img)


def _decode_libjpeg(buffers, n_threads: int) -> List[np.ndarray]:
    """``ssd_keras_tpu.native.decode_jpeg_batch``, raising where it returns
    None."""
    lib = _load_libjpeg()
    n = len(buffers)
    if n_threads <= 0:
        n_threads = min(n, os.cpu_count() or 4)
    bufs = [np.frombuffer(b, dtype=np.uint8) for b in buffers]
    out: List[Optional[np.ndarray]] = [None] * n
    native = []  # (index, shape) of the files libjpeg decodes
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    for i, b in enumerate(bufs):
        if lib.ssd_jpeg_dims(b.ctypes.data, b.size, ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(c)) != 0:
            raise ValueError(f"Invalid JPEG header in image {i}.")
        if c.value == 1:
            native.append((i, (h.value, w.value)))
        elif c.value == 3:
            native.append((i, (h.value, w.value, 3)))
        else:  # component counts libjpeg cannot deliver as RGB
            out[i] = _pil(buffers[i])
    if native:
        m = len(native)
        for i, shape in native:
            out[i] = np.empty(shape, np.uint8)

        def ints(values):
            return (ctypes.c_int * m)(*values)

        status = ints([0] * m)
        failures = lib.ssd_decode_jpeg_batch(
            (ctypes.c_void_p * m)(*[bufs[i].ctypes.data for i, _ in native]),
            ints([bufs[i].size for i, _ in native]), m,
            (ctypes.c_void_p * m)(*[out[i].ctypes.data for i, _ in native]),
            ints([s[0] for _, s in native]), ints([s[1] for _, s in native]),
            ints([1 if len(s) == 2 else 3 for _, s in native]), min(n_threads, m), status)
        if failures:
            bad = [native[k][0] for k in range(m) if status[k] != 0]
            raise ValueError(f"JPEG decode failed for images {bad}.")
    return out


# --------------------------------------------------------------------------- #
# The card's decoder (nvJPEG)
# --------------------------------------------------------------------------- #


def _pinned(name: str, nbytes: int) -> torch.Tensor:
    buf = _PINNED.get(name)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8, pin_memory=True)
        _PINNED[name] = buf
    return buf


def _recorded(stream) -> torch.cuda.Event:
    event = torch.cuda.Event()
    event.record(stream)
    return event


def _header(lib, index: int, i: int, buf: np.ndarray):
    """(components, subsampling, widths, heights) of file ``i``: nvJPEG's
    reading of its frame header, a size for each component."""
    comps, css = ctypes.c_int(), ctypes.c_int()
    widths, heights = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
    code = lib.ssd_nvjpeg_info(index, buf.ctypes.data, buf.size, ctypes.byref(comps),
                               ctypes.byref(css), widths, heights)
    if code != 0:
        raise ValueError(f"Invalid JPEG header in image {i}: {_status(code)}.")
    return comps.value, css.value, list(widths), list(heights)


def _kind(comps: int, css: int, widths, heights) -> Optional[int]:
    """The colour kernel's kind for a file, or None for PIL: gray, or three
    components at 4:4:4, 4:2:2 or 4:2:0 whose planes have libjpeg's sizes."""
    h, w = heights[0], widths[0]
    if comps == 1 and css == _CSS_GRAY:
        return jpeg_color.KIND_GRAY
    kind = _CSS_KIND.get(css) if comps == 3 else None
    if kind is None or h < 1 or w < 1:
        return None
    chroma = jpeg_color.chroma_shape(kind, h, w)
    if any((heights[c], widths[c]) != chroma for c in (1, 2)):
        return None
    return kind


def _scan(lib, index: int, bufs):
    """Read the headers of ``bufs`` on card ``index``: (files, rows,
    planes_at, planes_bytes, out_bytes), ``files`` the indices the colour
    kernel takes (the rest are for PIL), ``rows`` their rows for it
    (``ops/jpeg_color.py``), ``planes_at`` three (offset, pitch) a file."""
    files, rows, planes_at = [], [], []
    planes_bytes = out_bytes = 0
    for i, buf in enumerate(bufs):
        comps, css, widths, heights = _header(lib, index, i, buf)
        kind = _kind(comps, css, widths, heights)
        if kind is None:
            continue
        offsets = []
        for c in range(comps):
            offsets.append((planes_bytes, widths[c]))
            planes_bytes += widths[c] * heights[c]
        offsets += [(None, 0)] * (3 - comps)
        h, w = heights[0], widths[0]
        ch, cw = (heights[1], widths[1]) if comps == 3 else (0, 0)
        rows.append([offsets[0][0], offsets[1][0] or 0, offsets[2][0] or 0, cw, ch, h, w, kind,
                     out_bytes])
        planes_at += offsets
        files.append(i)
        out_bytes += h * w * (1 if kind == jpeg_color.KIND_GRAY else 3)
    return files, rows, planes_at, planes_bytes, out_bytes


def _planes(lib, index: int, bufs, stream, scanned=None):
    """Decode ``bufs`` on card ``index`` to their planes: (planes, layout,
    out_bytes, files), ``files`` the indices decoded (the rest are for PIL)
    and ``layout`` their rows for the colour kernel (``ops/jpeg_color.py``);
    ``scanned`` is ``_scan``'s answer, if read already. The caller holds
    ``_LOCK``."""
    files, rows, planes_at, planes_bytes, out_bytes = scanned or _scan(lib, index, bufs)
    planes = torch.empty(planes_bytes, dtype=torch.uint8, device=torch.device("cuda", index))
    if files:
        _decode_batched(lib, index, bufs, files, planes, planes_at, stream)
    layout = torch.tensor(rows, dtype=torch.int64).reshape(-1, len(jpeg_color.LAYOUT_FIELDS))
    return planes, layout, out_bytes, files


def decode_planes(buffers, device=None):
    """The card's decode up to the colour kernel: ``(planes, layout,
    out_bytes, files)`` for ``kernels/jpeg_color.py:ycc_to_rgb`` and its
    plain version (``files``: the indices of ``buffers`` decoded; the rest
    would go to PIL). For checks of the kernel on real planes."""
    from ssd_keras_torch.kernels.build import load_nvjpeg_library

    device = _device(device)
    if device.type != "cuda":
        raise ValueError("decode_planes decodes on the card")
    lib = load_nvjpeg_library()
    index = torch.cuda.current_device() if device.index is None else device.index
    bufs = [np.frombuffer(b, dtype=np.uint8) for b in buffers]
    with _LOCK, torch.cuda.device(index):
        stream = torch.cuda.current_stream(index)
        result = _planes(lib, index, bufs, stream)
        stream.synchronize()
    return result


def decode_packed(buffers, device=None, accept=None):
    """The card's decode of a batch that stays on the card: ``(pixels,
    layout)``, the colour kernel's flat uint8 output on ``device`` and its
    CPU int64 layout (one row a file, in order; ``ops/jpeg_color.py``), or
    None, before anything is decoded, when a file is not one the colour
    kernel takes (it would go to PIL) or ``accept(height, width)`` refuses
    one's size. Nothing waits for the card: the pixels are ready in the
    current stream's order. A corrupt file raises as in
    ``decode_jpeg_batch``."""
    from ssd_keras_torch.kernels import jpeg_color as color_kernel
    from ssd_keras_torch.kernels.build import load_nvjpeg_library

    device = _device(device)
    if device.type != "cuda":
        raise ValueError("decode_packed decodes on the card")
    lib = load_nvjpeg_library()
    index = torch.cuda.current_device() if device.index is None else device.index
    bufs = [np.frombuffer(b, dtype=np.uint8) for b in buffers]
    with _LOCK, torch.cuda.device(index):
        scanned = _scan(lib, index, bufs)
        files, rows = scanned[0], scanned[1]
        if len(files) != len(bufs) or (accept is not None and not all(
                accept(*row[5:7]) for row in rows)):  # a row's height, width
            return None
        stream = torch.cuda.current_stream(index)
        planes, layout, out_bytes, _ = _planes(lib, index, bufs, stream, scanned)
        return color_kernel.ycc_to_rgb(planes, layout, out_bytes), layout


def _decode_nvjpeg(buffers, device: torch.device) -> List[np.ndarray]:
    from ssd_keras_torch.kernels import jpeg_color as color_kernel
    from ssd_keras_torch.kernels.build import load_nvjpeg_library

    lib = load_nvjpeg_library()
    index = torch.cuda.current_device() if device.index is None else device.index
    bufs = [np.frombuffer(b, dtype=np.uint8) for b in buffers]
    out: List[Optional[np.ndarray]] = [None] * len(bufs)
    with _LOCK, torch.cuda.device(index):
        stream = torch.cuda.current_stream(index)
        planes, layout, out_bytes, files = _planes(lib, index, bufs, stream)
        if files:
            pixels = color_kernel.ycc_to_rgb(planes, layout, out_bytes)
            host = _pinned("pixels", out_bytes)
            host[:out_bytes].copy_(pixels, non_blocking=True)
            stream.synchronize()
            host_np = host.numpy()
            for i, (_, _, _, _, _, h, w, kind, off) in zip(files, layout.tolist()):
                shape = (h, w) if kind == jpeg_color.KIND_GRAY else (h, w, 3)
                out[i] = host_np[off:off + int(np.prod(shape))].reshape(shape).copy()
    for i, arr in enumerate(out):
        if arr is None:
            out[i] = _pil(buffers[i])
    return out


def _decode_batched(lib, index, bufs, files, planes, planes_at, stream) -> None:
    """One ``nvjpegDecodeBatched`` call over ``files``, their bitstreams
    staged one after another in pinned memory, their planes written into
    ``planes`` at ``planes_at`` (three (offset, pitch) a file). If it fails,
    each file is decoded alone to name the one at fault, and the call
    raises."""
    m = len(files)
    sizes = np.array([bufs[i].size for i in files], dtype=np.int64)
    starts = np.cumsum(sizes) - sizes
    decoding = _DECODING.pop("bitstreams", None)
    if decoding is not None:
        decoding.synchronize()  # the last decode has read the staged bitstreams
    staged = _pinned("bitstreams", int(sizes.sum()))
    staged_np = staged.numpy()
    for i, start, size in zip(files, starts, sizes):
        staged_np[start:start + size] = bufs[i]
    base = planes.data_ptr()
    ptrs = [None if off is None else base + off for off, _ in planes_at]

    def decode(which):
        k = len(which)
        return lib.ssd_nvjpeg_decode_batched(
            index, (ctypes.c_void_p * k)(*[staged.data_ptr() + int(starts[j]) for j in which]),
            (ctypes.c_size_t * k)(*[int(sizes[j]) for j in which]), k,
            (ctypes.c_void_p * (3 * k))(*[ptrs[3 * j + c] for j in which for c in range(3)]),
            (ctypes.c_size_t * (3 * k))(*[planes_at[3 * j + c][1] for j in which
                                          for c in range(3)]),
            0, stream.cuda_stream)

    try:
        code = decode(range(m))
        count("nvjpeg.batches")
        if code != 0:
            for j in range(m):
                one = decode([j])
                if one != 0:
                    raise ValueError(f"nvJPEG could not decode image {files[j]}: "
                                     f"{_status(one)}.")
            raise ValueError(f"nvjpegDecodeBatched failed over images {files}: "
                             f"{_status(code)}, though each decodes alone.")
    finally:
        _DECODING["bitstreams"] = _recorded(stream)


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #


def _device(device) -> torch.device:
    """``device`` (None: the card) checked: a CUDA device without a card
    raises ``RuntimeError``; nothing falls back to the CPU."""
    device = target_device("cuda" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no JPEG decoder for device {device}")
    return device


def decode_jpeg_batch(buffers, n_threads: int = 0, device=None) -> List[np.ndarray]:
    """Decode a list of JPEG byte strings to uint8 arrays.

    Color files yield (H, W, 3) RGB and grayscale files (H, W), the shapes
    ``np.array(PIL.Image.open(...))`` gives; 4-component files (CMYK, YCCK)
    are read one by one through PIL, with PIL's shape. ``device`` picks the
    backend that runs: None (the default) or a CUDA device decodes on the
    card through nvJPEG, and raises ``RuntimeError`` when no card is there;
    ``"cpu"`` decodes on the host through libjpeg (``ssd_jpeg.cpp``,
    ``n_threads`` wide, 0 = one thread a CPU, at most one a file), and
    raises ``RuntimeError`` where libjpeg is missing. A corrupt file raises
    ``ValueError`` naming its index.
    """
    device = _device(device)
    if not buffers:
        return []
    if device.type == "cpu":
        return _decode_libjpeg(buffers, n_threads)
    return _decode_nvjpeg(buffers, device)


def jpeg_available(device=None) -> bool:
    """Whether ``decode_jpeg_batch`` can decode on ``device`` (None: the
    card): a card is there and the nvJPEG decoder builds, or for ``"cpu"``
    libjpeg's decoder builds."""
    if device is not None and torch.device(device).type == "cpu":
        return _libjpeg()[0] is not None
    if not torch.cuda.is_available():
        return False
    from ssd_keras_torch.kernels.build import load_nvjpeg_library

    try:
        load_nvjpeg_library()
    except RuntimeError:
        return False
    return True
