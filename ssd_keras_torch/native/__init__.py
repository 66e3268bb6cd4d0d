"""ctypes bindings for the host C++ of the evaluation path (ssd_host_ops.cpp).

``ssd_host_ops.cpp`` is a copy of ``ssd_keras_tpu/native/ssd_host_ops.cpp``:
greedy NMS over one ragged candidate list, the evaluator's matching of one
class's predictions to the ground truth, and a pairwise IoU matrix, all in
f32 with the IoU of ``ops/boxes.py``. ``g++ -O3 -shared -fPIC`` builds it at
its first use into ``ssd_keras_torch/_build/`` (never next to the source),
named by a hash of the source, as ``kernels/build.py`` builds the CUDA
sources. Nothing falls back: a missing ``g++``, a failed build or a failed
load raises ``RuntimeError`` with the compiler's message. The NumPy loops
the JAX package falls back to are the plain versions here, called by name
(``decoder.greedy_nms_numpy``, ``Evaluator.match_predictions_numpy``).

The JAX package's threaded JPEG batch decoder is ported as ``jpeg.py``:
``decode_jpeg_batch(buffers, n_threads=0, device=None)`` decodes on the card
through nvJPEG (``nvjpeg_decode.cu``, built by ``kernels/build.py``), or, with
``device="cpu"``, through the port's copy of ``ssd_jpeg.cpp`` (libjpeg, built
here by g++ only where ``jpeglib.h`` is found). ``jpeg_available(device)``
says whether that device's decoder builds.

The augmentation chains' OpenCV arithmetic (resize, the affine warp, the
colour conversions) runs in ``ssd_image_ops.cpp`` through ``image_ops.py``,
built by the same g++ rule with ``-ffp-contract=off -fno-tree-vectorize``
(``image_ops.IMAGE_OPS_FLAGS``); ``image_ops_calls``
counts its calls by op. Each built library is named by a hash of its source
and of the g++ command's options.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ssd_keras_torch.native.image_ops import image_ops_calls, load_image_ops
from ssd_keras_torch.native.jpeg import decode_jpeg_batch, jpeg_available

__all__ = ["load_library", "greedy_nms_indices", "match_predictions_class", "iou_matrix",
           "gxx_command", "decode_jpeg_batch", "jpeg_available", "image_ops_calls",
           "load_image_ops", "SOURCE", "BUILD_DIR"]

SOURCE = Path(__file__).resolve().parent / "ssd_host_ops.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"


_GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def gxx_command(gxx: str, source: Path, output: Path, libraries: Sequence[str] = (),
                flags: Sequence[str] = ()) -> List[str]:
    """The g++ command line that builds ``source`` into ``output`` with the
    extra compiler ``flags``, linked with ``libraries``."""
    return [gxx, *_GXX_FLAGS, *flags, "-o", str(output), str(source), *libraries]


def _library_path(source: Path = SOURCE, libraries: Sequence[str] = (),
                  flags: Sequence[str] = ()) -> Path:
    """Where the library built from ``source`` lives: named by a hash of the
    source's bytes and of every option of the g++ command, so that a changed
    source or a changed flag builds anew."""
    options = "\0".join([*_GXX_FLAGS, *flags, *libraries]).encode()
    digest = hashlib.sha256(source.read_bytes() + b"\0" + options).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the host ops of ssd_keras_torch "
                           "cannot be built.")
    return gxx


def _build(lib: Path, source: Path = SOURCE, libraries: Sequence[str] = (),
           flags: Sequence[str] = ()) -> None:
    gxx = _gxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a private name, then rename, as kernels/build.py does.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(gxx_command(gxx, source, Path(tmp), libraries, flags),
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building {lib.name}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the host ops; declares every entry."""
    path = _library_path()
    if not path.exists():
        _build(path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    fp, i32p, u8p = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                     ctypes.POINTER(ctypes.c_uint8))
    lib.ssd_greedy_nms.restype = ctypes.c_int
    lib.ssd_greedy_nms.argtypes = [fp, fp, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int)]
    lib.ssd_match_predictions.restype = None
    lib.ssd_match_predictions.argtypes = [i32p, fp, ctypes.c_int, i32p, fp, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_float, ctypes.c_int, u8p, u8p]
    lib.ssd_iou_matrix.restype = None
    lib.ssd_iou_matrix.argtypes = [fp, ctypes.c_int, fp, ctypes.c_int, ctypes.c_int, fp]
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _boxes(a, name: str, n: Optional[int] = None) -> np.ndarray:
    """``a`` as a contiguous f32 (n, 4) array; raises on another shape, so
    that the C code reads no row it was not given."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    if a.ndim != 2 or a.shape[1] != 4 or (n is not None and a.shape[0] != n):
        want = f"({n}, 4)" if n is not None else "(n, 4)"
        raise ValueError(f"{name}: expected shape {want}, got {a.shape}")
    return a


def greedy_nms_indices(scores: np.ndarray, boxes: np.ndarray, iou_threshold: float,
                       border_delta: int = 0) -> np.ndarray:
    """Selection-order indices of the survivors of greedy NMS (f32)."""
    lib = load_library()
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    if scores.ndim != 1:
        raise ValueError(f"scores: expected one dimension, got shape {scores.shape}")
    n = scores.shape[0]
    boxes = _boxes(boxes, "boxes", n)
    keep = np.empty(n, dtype=np.int32)
    n_kept = lib.ssd_greedy_nms(_fptr(scores), _fptr(boxes), n, ctypes.c_float(iou_threshold),
                                int(border_delta),
                                keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return keep[:n_kept]


def match_predictions_class(
    pred_img: np.ndarray,  # (n_preds,) int32 dense image indices, conf-desc order
    pred_boxes: np.ndarray,  # (n_preds, 4) float32
    gt_offsets: np.ndarray,  # (n_images + 1,) int32
    gt_boxes: np.ndarray,  # (total_gt, 4) float32
    gt_neutral: Optional[np.ndarray],  # (total_gt,) uint8 or None
    iou_threshold: float,
    border_delta: int,
):
    """(tp, fp) uint8 arrays of one class's predictions, in their order."""
    lib = load_library()
    pred_img = np.ascontiguousarray(pred_img, dtype=np.int32)
    gt_offsets = np.ascontiguousarray(gt_offsets, dtype=np.int32)
    if pred_img.ndim != 1 or gt_offsets.ndim != 1 or gt_offsets.size < 1:
        raise ValueError("pred_img and gt_offsets must be one-dimensional, gt_offsets non-empty")
    n_preds, n_images = pred_img.shape[0], gt_offsets.shape[0] - 1
    pred_boxes = _boxes(pred_boxes, "pred_boxes", n_preds)
    gt_boxes = _boxes(gt_boxes, "gt_boxes")
    if (gt_offsets[0] != 0 or gt_offsets[-1] != gt_boxes.shape[0]
            or np.any(np.diff(gt_offsets) < 0)):
        raise ValueError(f"gt_offsets must rise from 0 to {gt_boxes.shape[0]} (the GT rows)")
    if n_preds and (pred_img.min() < 0 or pred_img.max() >= n_images):
        raise ValueError(f"pred_img holds an image index outside [0, {n_images})")
    tp = np.zeros(n_preds, dtype=np.uint8)
    fp = np.zeros(n_preds, dtype=np.uint8)
    neutral_ptr = None
    if gt_neutral is not None:
        gt_neutral = np.ascontiguousarray(gt_neutral, dtype=np.uint8)
        if gt_neutral.shape != (gt_boxes.shape[0],):
            raise ValueError(f"gt_neutral: expected shape ({gt_boxes.shape[0]},), "
                             f"got {gt_neutral.shape}")
        neutral_ptr = gt_neutral.ctypes.data_as(ctypes.c_void_p)
    lib.ssd_match_predictions(
        pred_img.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _fptr(pred_boxes), n_preds,
        gt_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _fptr(gt_boxes),
        neutral_ptr, n_images, ctypes.c_float(iou_threshold), int(border_delta),
        tp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        fp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return tp, fp


def iou_matrix(boxes1: np.ndarray, boxes2: np.ndarray, border_delta: int = 0) -> np.ndarray:
    """(m, n) f32 IoU of corner boxes ``boxes1`` (m, 4) and ``boxes2`` (n, 4)."""
    lib = load_library()
    boxes1, boxes2 = _boxes(boxes1, "boxes1"), _boxes(boxes2, "boxes2")
    m, n = boxes1.shape[0], boxes2.shape[0]
    out = np.empty((m, n), dtype=np.float32)
    lib.ssd_iou_matrix(_fptr(boxes1), m, _fptr(boxes2), n, int(border_delta), _fptr(out))
    return out
