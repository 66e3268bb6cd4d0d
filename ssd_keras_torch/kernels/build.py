"""Build the port's CUDA sources into one shared library and load it.

``nvcc`` compiles ``ssd_keras_torch/csrc/*.cu`` (plain C entry points, no
PyTorch headers, so a build takes seconds) for Hopper (``sm_90a``) into
``ssd_keras_torch/_build/``, named by a hash of the sources: an edited
source builds anew at its first use, an unchanged one is loaded as it is.
Nothing falls back: a missing ``nvcc``, a failed build or a failed load
raises ``RuntimeError``.

Numerics flags: no ``--use_fast_math`` (IEEE division and denormals) and
``--fmad=false`` (no multiply-add contraction), so the kernels compute the
same f32 values as their plain PyTorch versions.
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
from typing import List, Sequence

__all__ = ["nvcc_command", "find_nvcc", "load_library", "CSRC_DIR", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else in ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.access(candidate, os.X_OK):
        return candidate
    raise RuntimeError(
        f"nvcc not found on PATH nor at {candidate}: the CUDA kernels of "
        "ssd_keras_torch cannot be built."
    )


def nvcc_command(nvcc: str, sources: Sequence[Path], output: Path) -> List[str]:
    """The nvcc command line that builds ``sources`` into ``output``."""
    return [
        nvcc,
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "--fmad=false",
        "-shared", "-Xcompiler", "-fPIC",
        "-o", str(output),
        *[str(s) for s in sources],
    ]


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _library_path(sources: Sequence[Path]) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libssd_kernels_{h.hexdigest()[:16]}.so"


def _build(sources: Sequence[Path], lib: Path) -> None:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a private name, then rename: a concurrent build of the same
    # sources never sees a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            nvcc_command(nvcc, sources, Path(tmp)), capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {lib.name}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels library; declares every entry."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    lib_path = _library_path(sources)
    if not lib_path.exists():
        _build(sources, lib_path)
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        raise RuntimeError(f"cannot load {lib_path}: {e}") from e
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ssd_greedy_nms.argtypes = [p, p, p, p, i, i, f, f, p]
    lib.ssd_greedy_nms.restype = ctypes.c_int
    lib.ssd_nms_iou_mask.argtypes = [p, p, p, i, i, f, f, p]
    lib.ssd_nms_iou_mask.restype = ctypes.c_int
    return lib
