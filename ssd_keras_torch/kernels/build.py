"""Build the port's CUDA sources into one shared library and load it.

``nvcc`` compiles ``ssd_keras_torch/csrc/*.cu`` (the NMS kernel, the JPEG
colour kernel, the uint8 linear resize and the convolutions' epilogue;
plain C entry points, no PyTorch
headers, so a build takes seconds) for Hopper (``sm_90a``), one nvcc a
source, all started together,
then links them into ``ssd_keras_torch/_build/``, named by a hash of the
sources: an edited source builds anew at its first use, an unchanged one is
loaded as it is. Nothing falls back: a missing ``nvcc``, a failed build or a
failed load raises ``RuntimeError``.

Numerics flags: no ``--use_fast_math`` (IEEE division and denormals) and
``--fmad=false`` (no multiply-add contraction), so the kernels compute the
same f32 values as their plain PyTorch versions.

The card's JPEG decoder (``ssd_keras_torch/native/nvjpeg_decode.cu``, over
the CUDA toolkit's nvJPEG) is a library of its own, built by the same rule
and linked with ``-lnvjpeg`` from ``$CUDA_HOME/lib64``
(``load_nvjpeg_library``), so the kernels never depend on nvJPEG. Its
header and library come from the toolkit that holds ``nvcc``
(``$CUDA_HOME``, else ``nvcc``'s own directory); a missing ``nvjpeg.h``
raises.

Every wrapper calls its C entry through :func:`launch`, on its tensors'
card and that card's current stream.
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

import torch

__all__ = ["nvcc_command", "find_nvcc", "launch", "load_library", "load_nvjpeg_library",
           "nvjpeg_flags", "raw_stream", "CSRC_DIR", "BUILD_DIR", "NVJPEG_SOURCE"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVJPEG_SOURCE = _PKG / "native" / "nvjpeg_decode.cu"


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


def nvcc_command(nvcc: str, sources: Sequence[Path], output: Path,
                 libraries: Sequence[str] = (), compile_only: bool = False) -> List[str]:
    """The nvcc command line that builds ``sources`` into the shared library
    ``output``, linked with ``libraries`` (flags after the sources), or with
    ``compile_only`` one source into the object ``output``."""
    return [
        nvcc,
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "--fmad=false",
        "-c" if compile_only else "-shared", "-Xcompiler", "-fPIC",
        "-o", str(output),
        *[str(s) for s in sources],
        *libraries,
    ]


def nvjpeg_flags(nvcc: str) -> List[str]:
    """The flags that compile against and link nvJPEG: the toolkit's
    ``include`` and ``lib64`` under ``$CUDA_HOME`` (else ``nvcc``'s
    toolkit), the library's directory also as the run-time path. Raises
    ``RuntimeError`` when ``nvjpeg.h`` is not there."""
    home = os.environ.get("CUDA_HOME") or str(Path(nvcc).resolve().parent.parent)
    include, lib = Path(home) / "include", Path(home) / "lib64"
    if not (include / "nvjpeg.h").is_file():
        raise RuntimeError(
            f"nvjpeg.h not found in {include}: the nvJPEG decoder of ssd_keras_torch "
            "cannot be built (set CUDA_HOME to a CUDA toolkit that has nvJPEG)."
        )
    return [f"-I{include}", f"-L{lib}", "-lnvjpeg", "-Xlinker", f"-rpath,{lib}"]


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _library_path(sources: Sequence[Path], stem: str = "libssd_kernels") -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _run(commands: Sequence[List[str]], lib: Path) -> None:
    """Run ``commands`` all at once; raises with the first failure's
    output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in commands]
    results = [(proc.returncode, out, err) for proc in procs
               for out, err in [proc.communicate()]]
    for code, out, err in results:
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}) building {lib.name}:\n{out}\n{err}")


def _build(sources: Sequence[Path], lib: Path, nvjpeg: bool = False) -> None:
    """Compile each source with its own nvcc, all started together, then
    link the objects into ``lib``."""
    nvcc = find_nvcc()
    libraries = nvjpeg_flags(nvcc) if nvjpeg else []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to private names, then rename: a concurrent build of the same
    # sources never sees a half-written library.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / f"{i}_{src.stem}.o" for i, src in enumerate(sources)]
        _run([nvcc_command(nvcc, [src], obj, libraries, compile_only=True)
              for src, obj in zip(sources, objects)], lib)
        linked = Path(tmp) / lib.name
        _run([nvcc_command(nvcc, objects, linked, libraries)], lib)
        os.replace(linked, lib)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels library; declares every entry."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    lib_path = _library_path(sources)
    if not lib_path.exists():
        _build(sources, lib_path)
    lib = _load(lib_path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ssd_greedy_nms.argtypes = [p, p, p, p, i, i, f, f, p]
    lib.ssd_greedy_nms.restype = ctypes.c_int
    lib.ssd_nms_iou_mask.argtypes = [p, p, p, i, i, f, f, p]
    lib.ssd_nms_iou_mask.restype = ctypes.c_int
    lib.ssd_jpeg_ycc_to_rgb.argtypes = [p, ctypes.c_longlong, p, p, p, i, p]
    lib.ssd_jpeg_ycc_to_rgb.restype = ctypes.c_int
    lib.ssd_resize_linear_u8.argtypes = [p, p, i, i, i, p, p]
    lib.ssd_resize_linear_u8.restype = ctypes.c_int
    q = ctypes.c_longlong
    lib.ssd_conv_epilogue.argtypes = [p, p, p, i, q, q, q, i, p]
    lib.ssd_conv_epilogue.restype = ctypes.c_int
    lib.ssd_conv_epilogue_pool.argtypes = [p, p, p, i, q, q, q, q, q, q, i, i, i, p]
    lib.ssd_conv_epilogue_pool.restype = ctypes.c_int
    return lib


def raw_stream(index: int) -> int:
    """Card ``index``'s current stream as a raw handle (what
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without making a
    Stream object)."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the kernels library's C entry ``entry`` with ``args`` and then
    the raw handle of ``device``'s current stream, on that card; raises
    ``RuntimeError`` on a non-zero status. The device is switched only when
    it is not the current one, through the raw calls behind
    ``torch.cuda.current_device``: every convolution of an eager forward
    comes here, so the host's few microseconds count."""
    index = device.index
    fn = getattr(load_library(), entry)
    stream = raw_stream(index)
    if index == torch._C._cuda_getDevice():
        status = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            status = fn(*args, stream)
    if status != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {status}")


def _load(lib_path: Path) -> ctypes.CDLL:
    try:
        return ctypes.CDLL(str(lib_path))
    except OSError as e:
        raise RuntimeError(f"cannot load {lib_path}: {e}") from e


@functools.lru_cache(maxsize=None)
def load_nvjpeg_library() -> ctypes.CDLL:
    """Build (if needed) and load the nvJPEG decoder; declares every entry."""
    lib_path = _library_path([NVJPEG_SOURCE], "libssd_nvjpeg")
    if not lib_path.exists():
        _build([NVJPEG_SOURCE], lib_path, nvjpeg=True)
    lib = _load(lib_path)
    p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip = ctypes.POINTER(ctypes.c_int)
    lib.ssd_nvjpeg_info.argtypes = [i, p, z, ip, ip, ip, ip]
    lib.ssd_nvjpeg_info.restype = i
    lib.ssd_nvjpeg_decode_batched.argtypes = [i, p, p, i, p, p, i, p]
    lib.ssd_nvjpeg_decode_batched.restype = i
    return lib
