"""The port's JPEG batch decoder against the JAX package's, on the CPU.

* ``ssd_keras_torch.native.decode_jpeg_batch(device="cpu")`` (the port's
  copy of ``ssd_jpeg.cpp``, libjpeg) against ``ssd_keras_tpu.native.
  decode_jpeg_batch``: bit for bit, RGB 4:2:0, 4:2:2 and 4:4:4, gray (H, W),
  CMYK through PIL, progressive and restart-marked files, odd sizes; skipped
  where this host has no libjpeg.
* ``DataGenerator``'s JPEG batch path against the JAX package's under the
  same seeds; mixed JPEG/PNG batches, in-memory datasets and
  ``jpeg_device=None`` take PIL in both.
* The card's decoder (nvJPEG) without a card raises and never falls back
  to the CPU; its build fails loudly without ``nvcc`` or ``nvjpeg.h``.
* The colour kernel's plain version (``ops/jpeg_color.py``, libjpeg's
  upsampling and YCbCr -> RGB) equals PIL's decode bit for bit on JPEGs
  whose planes are known exactly, and its wrapper's dispatch and checks.

Every image is made here from a seed and encoded by PIL; no file is
committed. The card's side is ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 14.
"""

import inspect
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import (JPEG_COLOR_CASES, JPEG_COLOR_HEIGHTS, JPEG_COLOR_WIDTHS,
                        jpeg_color_case)
from ssd_keras_torch import native
from ssd_keras_torch.data import datasets
from ssd_keras_torch.data.geometric import Resize
from ssd_keras_torch.kernels import build
from ssd_keras_torch.kernels import jpeg_color as color_kernel
from ssd_keras_torch.native import jpeg
from ssd_keras_torch.ops import jpeg_color
from ssd_keras_torch.utils import profiling
from ssd_keras_tpu import native as jax_native
from ssd_keras_tpu.data import datasets as jax_datasets
from ssd_keras_tpu.data.geometric import Resize as JaxResize

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def libjpeg():
    """Both host decoders, or a skip where libjpeg is missing."""
    if not jax_native.jpeg_available():
        pytest.skip("the JAX package's native JPEG decoder is unavailable (no libjpeg?)")
    if not jpeg.jpeg_available("cpu"):
        pytest.skip(f"no libjpeg for the port's host decoder: {jpeg._libjpeg()[1]}")


def _encode(image, **options) -> bytes:
    buf = io.BytesIO()
    if image.ndim == 3 and image.shape[2] == 4:
        Image.fromarray(image[..., :3]).convert("CMYK").save(buf, "JPEG", **options)
    else:
        Image.fromarray(image).save(buf, "JPEG", **options)
    return buf.getvalue()


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as img:
        return np.array(img)


def _scene(rng, h, w, channels=3):
    """A smooth gradient with noise and a sharp coloured rectangle: chroma
    edges for the upsampling, texture for the IDCT."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255.0 / w, y * 255.0 / h, (x + y) * 127.0 / (w + h)], -1)
    img += rng.randint(-25, 25, img.shape)
    img[h // 4:h // 2 + 1, w // 3:w // 2 + 1] = rng.randint(0, 256, 3)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if channels == 1:
        return np.asarray(Image.fromarray(img).convert("L"))
    if channels == 4:
        return np.concatenate([img, img[..., :1]], -1)
    return img


_CASES = {
    "rgb_420": [((64, 80), {"subsampling": 2, "quality": 90}),
                ((37, 53), {"subsampling": 2, "quality": 75})],
    "rgb_422": [((40, 52), {"subsampling": 1, "quality": 90})],
    "rgb_444": [((48, 48), {"subsampling": 0, "quality": 95}),
                ((33, 17), {"subsampling": 0, "quality": 75})],
    "gray": [((56, 72, 1), {"quality": 92}), ((13, 7, 1), {"quality": 60})],
    "cmyk_through_pil": [((36, 44, 4), {"quality": 92}), ((40, 52), {"quality": 92})],
    "all_cmyk": [((36, 44, 4), {"quality": 92}), ((20, 30, 4), {"quality": 80})],
    "progressive_and_restart": [((45, 61), {"progressive": True, "quality": 90}),
                                ((45, 61), {"restart_marker_blocks": 2, "quality": 90})],
    "mixed_batch": [((64, 80), {"subsampling": 2}), ((31, 29, 1), {}), ((36, 44, 4), {}),
                    ((50, 70), {"subsampling": 0, "progressive": True}),
                    ((23, 45), {"subsampling": 1}), ((1, 1), {}), ((9, 3), {"subsampling": 2})],
}


def _buffers(case, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for shape, options in _CASES[case]:
        h, w = shape[:2]
        out.append(_encode(_scene(rng, h, w, shape[2] if len(shape) == 3 else 3), **options))
    return out


@pytest.mark.parametrize("n_threads", [0, 1, 3])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_cpu_decode_equals_the_jax_decoder(libjpeg, case, n_threads):
    buffers = _buffers(case)
    got = native.decode_jpeg_batch(buffers, n_threads=n_threads, device="cpu")
    want = jax_native.decode_jpeg_batch(buffers, n_threads=n_threads)
    assert len(got) == len(want) == len(buffers)
    for g, w, b in zip(got, want, buffers):
        assert g.dtype == w.dtype == np.uint8
        assert g.shape == w.shape == _pil(b).shape
        np.testing.assert_array_equal(g, w)


def test_cpu_decode_of_an_empty_batch_is_empty(libjpeg):
    assert native.decode_jpeg_batch([], device="cpu") == []


def test_cpu_decode_raises_on_a_corrupt_file_as_jax_does(libjpeg):
    good = _buffers("rgb_420")[0]
    for bad in (b"not a jpeg", good[:100]):
        with pytest.raises(ValueError, match="image 1"):
            native.decode_jpeg_batch([good, bad], device="cpu")
        with pytest.raises(ValueError):
            jax_native.decode_jpeg_batch([good, bad])


def test_host_decoder_source_is_the_jax_packages():
    """The port's ``ssd_jpeg.cpp`` is the JAX file below its header, so the
    two decode bit for bit alike."""
    ours = jpeg.JPEG_SOURCE.read_text()
    theirs = (REPO / "ssd_keras_tpu" / "native" / "ssd_jpeg.cpp").read_text()
    body = theirs[theirs.index("#include <csetjmp>"):]
    assert ours.endswith(body)


@pytest.fixture()
def no_libjpeg(tmp_path, monkeypatch):
    """A host without libjpeg's header: an empty build directory and a
    header name g++ cannot find."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(jpeg, "JPEG_HEADER", "no_such_jpeglib_header.h")
    jpeg._libjpeg.cache_clear()
    yield tmp_path / "_build"
    jpeg._libjpeg.cache_clear()


def test_cpu_decoder_without_libjpeg_raises_and_reads_nothing_through_pil(no_libjpeg,
                                                                          monkeypatch):
    def no_pil(_):
        raise AssertionError("fell back to PIL")

    monkeypatch.setattr(jpeg, "_pil", no_pil)
    assert not jpeg.jpeg_available("cpu")
    with pytest.raises(RuntimeError, match="no_such_jpeglib_header.h not found"):
        native.decode_jpeg_batch(_buffers("rgb_420"), device="cpu")
    assert not no_libjpeg.exists() or not list(no_libjpeg.iterdir())


def test_cpu_decoder_builds_with_libjpeg(libjpeg, tmp_path, monkeypatch):
    """The g++ rule of the host ops with ``-ljpeg -lpthread``, into the
    build directory, named by a hash of the source."""
    seen = []
    real = native.gxx_command
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "gxx_command", lambda *a: seen.append(a) or real(*a))
    jpeg._libjpeg.cache_clear()
    try:
        assert jpeg.jpeg_available("cpu")
    finally:
        jpeg._libjpeg.cache_clear()
    (gxx, source, output, libraries, flags), = seen
    assert source == jpeg.JPEG_SOURCE and list(libraries) == ["-ljpeg", "-lpthread"]
    assert list(flags) == []
    assert output.parent == tmp_path / "_build" and not output.exists()
    assert [p.name for p in (tmp_path / "_build").glob("*.so")] == [
        native._library_path(jpeg.JPEG_SOURCE, jpeg.JPEG_LIBRARIES).name]


# --------------------------------------------------------------------------- #
# DataGenerator's JPEG batch path
# --------------------------------------------------------------------------- #


def _folder(tmp_path, sizes, exts=None, seed=1):
    rng = np.random.RandomState(seed)
    files, labels = [], []
    for k, (h, w) in enumerate(sizes):
        ext = exts[k] if exts else "jpg"
        path = tmp_path / f"im{k:02d}.{ext}"
        Image.fromarray(_scene(rng, h, w)).save(path, quality=90)
        files.append(str(path))
        x0, y0 = rng.randint(0, w // 2), rng.randint(0, h // 2)
        labels.append(np.array([[1 + k % 3, x0, y0, x0 + w // 3, y0 + h // 3]], np.float64))
    return files, labels


class _Counted:
    """Wraps a decoder, counting its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.fixture()
def counted(monkeypatch):
    port = _Counted(native.decode_jpeg_batch)
    jax = _Counted(jax_native.decode_jpeg_batch)
    monkeypatch.setattr(native, "decode_jpeg_batch", port)
    monkeypatch.setattr(jax_native, "decode_jpeg_batch", jax)
    return port, jax


def _batches(gen_cls, files, labels, transforms, n, seed, shuffle=True, **kwargs):
    gen = gen_cls(filenames=files, labels=labels, verbose=False, **kwargs)
    np.random.seed(seed)
    it = gen.generate(batch_size=3, shuffle=shuffle, transformations=transforms,
                      returns=["processed_images", "processed_labels", "filenames"])
    return [next(it) for _ in range(n)]


def _assert_same_batches(ours, theirs):
    for (xa, la, fa), (xb, lb, fb) in zip(ours, theirs):
        assert list(fa) == list(fb)
        assert len(xa) == len(xb)
        for a, b in zip(xa, xb):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", ["one_size", "resized", "gray_files"])
def test_generator_jpeg_batches_equal_jax(libjpeg, counted, tmp_path, case):
    """Two epochs of 7 lazy JPEG files in batches of 3 (the last one short),
    shuffled from one seed: the port's batch path on the host decoder gives
    the JAX package's batches, and both decode each batch in one call."""
    if case in ("one_size", "gray_files"):
        sizes, transforms = [(40, 56)] * 7, lambda mod: []
    else:
        sizes = [(40, 56), (37, 61), (64, 48), (29, 33), (50, 50), (41, 57), (33, 65)]
        transforms = lambda mod: [mod(height=48, width=64)]  # noqa: E731
    files, labels = _folder(tmp_path, sizes)
    if case == "gray_files":  # (H, W) images, as PIL reads them
        for f in files:
            Image.open(f).convert("L").save(f, quality=90)
    port, jax = counted
    ours = _batches(datasets.DataGenerator, files, labels, transforms(Resize), 6, 3,
                    jpeg_device="cpu")
    theirs = _batches(jax_datasets.DataGenerator, files, labels, transforms(JaxResize), 6, 3)
    _assert_same_batches(ours, theirs)
    assert port.calls == jax.calls == 6


@pytest.mark.parametrize("case", ["mixed_jpeg_png", "png_only", "in_memory"])
def test_generator_pil_path_in_both_packages(libjpeg, counted, tmp_path, case):
    """A batch that is not all lazy JPEG files is read one file at a time
    through PIL in both packages: neither batch decoder is called. (In file
    order, so that every batch of the mixed folder is mixed.)"""
    exts = {"mixed_jpeg_png": ["jpg", "png", "jpeg", "png", "JPG", "jpg"],
            "png_only": ["png"] * 6, "in_memory": ["jpg"] * 6}[case]
    files, labels = _folder(tmp_path, [(40, 56)] * 6, exts)
    kwargs = {"load_images_into_memory": case == "in_memory"}
    ours = _batches(datasets.DataGenerator, files, labels, [], 4, 5, shuffle=False,
                    jpeg_device="cpu", **kwargs)
    theirs = _batches(jax_datasets.DataGenerator, files, labels, [], 4, 5, shuffle=False,
                      **kwargs)
    _assert_same_batches(ours, theirs)
    assert counted[0].calls == counted[1].calls == 0
    for images, _, names in ours:
        for image, name in zip(images, names):
            np.testing.assert_array_equal(image, np.array(Image.open(name)))


def test_generator_jpeg_device_none_reads_through_pil(counted, tmp_path):
    files, labels = _folder(tmp_path, [(40, 56)] * 4)
    batches = _batches(datasets.DataGenerator, files, labels, [], 2, 0, jpeg_device=None)
    assert counted[0].calls == 0
    for images, _, names in batches:
        for image, name in zip(images, names):
            np.testing.assert_array_equal(image, np.array(Image.open(name)))


def test_generator_passes_its_jpeg_device(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(native, "decode_jpeg_batch",
                        lambda buffers, device=None, **k: seen.append(device) or
                        [_pil(b) for b in buffers])
    files, labels = _folder(tmp_path, [(40, 56)] * 3)
    for device in ("cuda", "cuda:1", "cpu"):
        _batches(datasets.DataGenerator, files, labels, [], 1, 0, jpeg_device=device)
    assert seen == ["cuda", "cuda:1", "cpu"]


# --------------------------------------------------------------------------- #
# The card's decoder, here without a card
# --------------------------------------------------------------------------- #


def test_decoders_default_to_the_card():
    assert inspect.signature(native.decode_jpeg_batch).parameters["device"].default is None
    assert inspect.signature(native.jpeg_available).parameters["device"].default is None
    assert inspect.signature(
        datasets.DataGenerator.__init__).parameters["jpeg_device"].default == "cuda"


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_card_decode_without_a_card_raises_and_does_not_fall_back(device, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default decodes there")

    def fail(*_, **__):
        raise AssertionError("fell back")

    monkeypatch.setattr(jpeg, "_decode_libjpeg", fail)
    monkeypatch.setattr(jpeg, "_pil", fail)
    monkeypatch.setattr(build, "load_nvjpeg_library", fail)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        native.decode_jpeg_batch(_buffers("rgb_420"), device=device)
    assert not native.jpeg_available(device)


def test_generator_on_the_card_without_one_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default decodes there")
    monkeypatch.setattr(datasets.DataGenerator, "_read_image",
                        staticmethod(lambda _: pytest.fail("fell back to PIL")))
    files, labels = _folder(tmp_path, [(40, 56)] * 3)
    gen = datasets.DataGenerator(filenames=files, labels=labels)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(gen.generate(batch_size=3, shuffle=False, returns=["processed_images"]))


def test_unknown_device_raises():
    with pytest.raises(ValueError, match="no JPEG decoder"):
        native.decode_jpeg_batch(_buffers("rgb_420"), device="meta")


# --------------------------------------------------------------------------- #
# The nvJPEG build
# --------------------------------------------------------------------------- #


def _fake_nvcc(tmp_path, script):
    """An ``nvcc`` on PATH that logs its arguments, then runs ``script``."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> {tmp_path / "nvcc.log"}\n{script}')
    nvcc.chmod(0o755)
    return bindir


def _log(tmp_path):
    path = tmp_path / "nvcc.log"
    return path.read_text().splitlines() if path.exists() else []


@pytest.fixture()
def empty_build(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path / "_build"


# An nvcc that writes a file that is not a library to its -o argument.
_WRITES_JUNK = 'while [ "$1" != "-o" ]; do shift; done\necho junk > "$2"\n'


@pytest.mark.parametrize("case", ["no_nvcc", "no_nvjpeg_header", "failed_compile"])
def test_nvjpeg_build_fails_loudly(case, empty_build, tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    home.mkdir()  # an empty CUDA_HOME: no bin/nvcc, no include/nvjpeg.h
    monkeypatch.setenv("CUDA_HOME", str(home))
    if case == "no_nvcc":
        monkeypatch.setenv("PATH", str(tmp_path / "empty"))
        match = "nvcc not found"
    elif case == "no_nvjpeg_header":
        monkeypatch.setenv("PATH", str(_fake_nvcc(tmp_path, _WRITES_JUNK)))
        match = f"nvjpeg.h not found in {home / 'include'}"
    else:
        (home / "include").mkdir()
        (home / "include" / "nvjpeg.h").write_text("#error broken\n")
        monkeypatch.setenv("PATH", str(_fake_nvcc(tmp_path, "echo 'error: broken' >&2\nexit 1\n")))
        match = "(?s)nvcc failed.*broken"
    with pytest.raises(RuntimeError, match=match):
        build.load_nvjpeg_library.__wrapped__()
    if case != "failed_compile":
        assert _log(tmp_path) == []  # nvcc never ran
    assert not empty_build.exists() or not list(empty_build.iterdir())


def test_nvjpeg_build_compiles_for_hopper_and_links_nvjpeg(empty_build, tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "include").mkdir(parents=True)
    (home / "include" / "nvjpeg.h").write_text("")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv("PATH", str(_fake_nvcc(tmp_path, _WRITES_JUNK)))
    with pytest.raises(RuntimeError, match="cannot load"):
        build.load_nvjpeg_library.__wrapped__()
    compile_line, link_line = _log(tmp_path)
    for line in (compile_line, link_line):
        assert "arch=compute_90a,code=sm_90a" in line and "--fmad=false" in line
        assert f"-L{home / 'lib64'}" in line and "-lnvjpeg" in line
        assert f"-rpath,{home / 'lib64'}" in line and f"-I{home / 'include'}" in line
    assert " -c " in compile_line and str(build.NVJPEG_SOURCE) in compile_line
    assert " -shared " in link_line and "_build" in link_line


def test_kernel_sources_compile_in_their_own_nvcc_runs(empty_build, tmp_path, monkeypatch):
    """Each CUDA source of the kernels library has its own nvcc, all started
    before the link (so they log in any order); the kernels never link
    nvJPEG."""
    monkeypatch.setenv("PATH", str(_fake_nvcc(tmp_path, _WRITES_JUNK)))
    with pytest.raises(RuntimeError, match="cannot load"):
        build.load_library.__wrapped__()
    lines = _log(tmp_path)
    compiles = [line for line in lines if " -c " in line]
    assert len(lines) == len(compiles) + 1 == len(build._sources()) + 1
    assert " -c " not in lines[-1]
    assert sorted(line.rsplit(" ", 1)[1] for line in compiles) == sorted(
        str(source) for source in build._sources())
    assert not any("nvjpeg" in line for line in lines)


# --------------------------------------------------------------------------- #
# The colour kernel's plain version and its wrapper
# --------------------------------------------------------------------------- #

_KINDS = {"444": (jpeg_color.KIND_444, 0, 1, 1), "422": (jpeg_color.KIND_422, 1, 2, 1),
          "420": (jpeg_color.KIND_420, 2, 2, 2)}


def _known_planes(rng, h, w, hs, vs):
    """Full-size Y, Cb, Cr whose JPEG planes are known exactly: Y constant
    on each 8x8 block and Cb, Cr on each of their blocks, so every DCT
    block holds its DC term alone, which quality 100 keeps exactly."""
    def blocks(bh, bw):
        grid = rng.randint(0, 256, ((h + bh - 1) // bh, (w + bw - 1) // bw))
        return np.repeat(np.repeat(grid, bh, 0), bw, 1)[:h, :w].astype(np.uint8)

    return blocks(8, 8), blocks(8 * vs, 8 * hs), blocks(8 * vs, 8 * hs)


def _batch(planes_list):
    """A flat planes buffer and its layout for [(kind, y, cb, cr)]."""
    flat, rows, planes_at = [], [], 0
    out = 0
    for kind, y, cb, cr in planes_list:
        h, w = y.shape
        y_off = planes_at
        flat.append(y.reshape(-1))
        planes_at += y.size
        cb_off = cr_off = cw = ch = 0
        if kind != jpeg_color.KIND_GRAY:
            ch, cw = cb.shape
            cb_off, cr_off = planes_at, planes_at + cb.size
            flat += [cb.reshape(-1), cr.reshape(-1)]
            planes_at += 2 * cb.size
        rows.append([y_off, cb_off, cr_off, cw, ch, h, w, kind, out])
        out += h * w * (1 if kind == jpeg_color.KIND_GRAY else 3)
    return (torch.from_numpy(np.concatenate(flat)), torch.tensor(rows, dtype=torch.int64), out)


_SIZES = [(37, 53), (251, 333), (16, 16), (5, 3), (9, 4), (1, 1), (2, 9)]
# The colour kernel's edge widths and heights (``chip_smoke.JPEG_COLOR_*``).
_SIZES += [(h, w) for h in JPEG_COLOR_HEIGHTS for w in JPEG_COLOR_WIDTHS if (h, w) not in _SIZES]


@pytest.mark.parametrize("size", _SIZES)
@pytest.mark.parametrize("name", sorted(_KINDS) + ["gray"])
def test_plain_colour_stage_equals_pil(name, size):
    """libjpeg's upsampling and conversion in PyTorch, on the planes of a
    JPEG made to hold exactly those planes, give PIL's decode bit for bit
    (the edges, odd sizes and chroma planes two samples wide included, at
    the colour kernel's edge widths 1-500 and heights 1-375)."""
    rng = np.random.RandomState(size[0] * 100 + size[1])
    h, w = size
    if name == "gray":
        y = _known_planes(rng, h, w, 1, 1)[0]
        data = _encode(y, quality=100)
        planes = [(jpeg_color.KIND_GRAY, y, None, None)]
    else:
        kind, sub, hs, vs = _KINDS[name]
        y, cb, cr = _known_planes(rng, h, w, hs, vs)
        buf = io.BytesIO()
        Image.merge("YCbCr", [Image.fromarray(p) for p in (y, cb, cr)]).save(
            buf, "JPEG", quality=100, subsampling=sub)
        data = buf.getvalue()
        planes = [(kind, y, cb[::vs, ::hs], cr[::vs, ::hs])]
        assert planes[0][2].shape == jpeg_color.chroma_shape(kind, h, w)
    flat, layout, out_bytes = _batch(planes)
    got = color_kernel.ycc_to_rgb(flat, layout, out_bytes).numpy()
    want = _pil(data)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_plain_colour_stage_lays_out_a_batch():
    """Several images in one call: each lands at its offset, and equals the
    same image converted alone."""
    rng = np.random.RandomState(3)
    items = []
    for name, (h, w) in (("420", (19, 23)), ("gray", (7, 5)), ("444", (8, 9)),
                         ("422", (10, 11))):
        if name == "gray":
            items.append((jpeg_color.KIND_GRAY, rng.randint(0, 256, (h, w), np.uint8), None,
                          None))
            continue
        kind, _, _, _ = _KINDS[name]
        ch, cw = jpeg_color.chroma_shape(kind, h, w)
        items.append((kind, rng.randint(0, 256, (h, w), np.uint8),
                      rng.randint(0, 256, (ch, cw), np.uint8),
                      rng.randint(0, 256, (ch, cw), np.uint8)))
    flat, layout, out_bytes = _batch(items)
    whole = jpeg_color.ycc_to_rgb(flat, layout, out_bytes)
    for row, item in zip(layout.tolist(), items):
        alone = jpeg_color.ycc_to_rgb(*_batch([item]))
        size = alone.numel()
        assert torch.equal(whole[row[8]:row[8] + size], alone)


@pytest.mark.parametrize("field, value, match", [
    (7, 4, "kind"), (5, 0, "kind"), (3, 7, "chroma"), (1, 10 ** 6, "outside the"),
    (8, 10 ** 6, "outside the"), (0, -1, "outside the"),
])
def test_colour_layout_is_checked(field, value, match):
    rng = np.random.RandomState(0)
    item = (jpeg_color.KIND_420, rng.randint(0, 256, (6, 7), np.uint8),
            rng.randint(0, 256, (3, 4), np.uint8), rng.randint(0, 256, (3, 4), np.uint8))
    flat, layout, out_bytes = _batch([item])
    layout[0, field] = value
    with pytest.raises(ValueError, match=match):
        color_kernel.ycc_to_rgb(flat, layout, out_bytes)


def test_colour_wrapper_dispatches_by_device():
    flat = torch.zeros(12, dtype=torch.uint8)
    layout = torch.tensor([[0, 0, 0, 0, 0, 3, 4, 0, 0]], dtype=torch.int64)
    before = profiling.counters().get("jpeg_color.launches", 0)
    assert torch.equal(color_kernel.ycc_to_rgb(flat, layout, 12), flat)
    # The CPU takes the plain version.
    assert profiling.counters().get("jpeg_color.launches", 0) == before
    with pytest.raises(ValueError, match="device"):
        color_kernel.ycc_to_rgb(torch.empty(12, dtype=torch.uint8, device="meta"), layout, 12)
    with pytest.raises(ValueError, match="uint8"):
        color_kernel.ycc_to_rgb(flat.float(), layout, 12)
    with pytest.raises(ValueError, match="CPU int64"):
        color_kernel.ycc_to_rgb(flat, layout.int(), 12)


# --------------------------------------------------------------------------- #
# The colour kernel's tiles
# --------------------------------------------------------------------------- #

_SOURCE = (REPO / "ssd_keras_torch" / "csrc" / "jpeg_color.cu").read_text()


def _constants():
    """The source's namespace-level ``constexpr int`` constants, each
    expression evaluated."""
    values = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", _SOURCE, re.M):
        values[name] = eval(expr.replace("/", "//"), {}, dict(values))  # integer arithmetic
    return values


def _round16(v):
    return (v + 15) & ~15


def test_tile_plan_constants_match_the_kernel_and_fit_its_staging():
    """The wrapper plans the tiles by the kernel's constants, and for every
    tile the plan gives, what the kernel stages fits its shared buffers (at
    the pitches the source computes): the Y rows, and 4:4:4's Cb and Cr
    rows, a plane each; both planes' raw subsampled chroma rows (4:2:0's
    context rows included); their (cb | cr << 16) words; the RGB rows; and
    one thread a staged row."""
    c = _constants()
    assert (c["kTileCols"], c["kTilePixels"], c["kTileRowsMax"], c["kBandFields"]) == (
        color_kernel.TILE_COLS, color_kernel.TILE_PIXELS, color_kernel.TILE_ROWS_MAX,
        color_kernel.BAND_FIELDS)
    assert c["kPlaneBytes"] + c["kRawBytes"] <= c["kStageBytes"] == 3 * c["kPlaneBytes"]
    for cols in range(1, color_kernel.TILE_COLS + 1):
        rows, tile_cols = color_kernel.tile_shape(cols)
        assert tile_cols == cols and rows % 2 == 0 and 2 <= rows <= color_kernel.TILE_ROWS_MAX
        groups = (cols + 7) // 8
        chroma_rows = max(rows // 2 + 2, rows)  # 4:2:0's context rows, 4:2:2's own
        assert rows * (_round16(cols) + 32) <= c["kPlaneBytes"]
        assert 2 * chroma_rows * (_round16(4 * groups + 4) + 48) <= c["kRawBytes"]
        assert chroma_rows * (4 * groups + 4) * 4 <= c["kWordBytes"]
        assert rows * (_round16(3 * cols) + 32) <= c["kRgbBytes"]
        assert rows + 2 * chroma_rows <= min(c["kOffsets"], c["kThreads"])
    assert color_kernel.tile_shape(4000) == color_kernel.tile_shape(color_kernel.TILE_COLS)


@pytest.mark.parametrize("case", sorted(JPEG_COLOR_CASES))
def test_tiles_cover_every_pixel_once(case):
    _, layout, _ = jpeg_color_case(case)
    rows = layout.numpy()
    tiles = color_kernel.bands(rows)
    assert tiles.dtype == np.int32 and tiles.shape[1] == color_kernel.BAND_FIELDS
    seen = [np.zeros((h, w), np.int32) for h, w in rows[:, 5:7]]
    for image, row0, col0, n in tiles.tolist():
        h, w = rows[image, 5:7]
        tile_rows, tile_cols = color_kernel.tile_shape(int(w))
        assert row0 % tile_rows == 0 and col0 % tile_cols == 0 and row0 % 2 == 0
        assert 1 <= n <= tile_rows and (n == tile_rows or row0 + n == h)
        seen[image][row0:row0 + n, col0:col0 + min(tile_cols, w - col0)] += 1
    assert all((s == 1).all() for s in seen)
    assert list(tiles[:, 0]) == sorted(tiles[:, 0])


def _tiles_like_the_kernel(planes, layout, out_bytes):
    """The kernel's computation in NumPy, tile by tile as it runs: each tile's
    staged chroma (context rows and columns clamped to the plane), each
    8-column group's six samples, the kernel's folded conversion
    constants. Holds the tiling and the kernel's index arithmetic (not its
    CUDA) to the plain version here."""
    rows = jpeg_color.check_layout(layout, planes.numel(), out_bytes)
    data = planes.numpy().astype(np.int64)
    out = np.zeros(out_bytes, np.uint8)
    for image, row0, col0, n in color_kernel.bands(rows).tolist():
        y_off, cb_off, cr_off, cw, ch, h, w, kind, off = rows[image].tolist()
        cols = min(color_kernel.TILE_COLS, w - col0)
        y = data[y_off:y_off + h * w].reshape(h, w)[row0:row0 + n, col0:col0 + cols]
        at = (np.arange(row0, row0 + n)[:, None] * w + np.arange(col0, col0 + cols))
        if kind == jpeg_color.KIND_GRAY:
            out[off + at] = y
            continue
        planes_cbcr = [data[o:o + ch * cw].reshape(ch, cw) for o in (cb_off, cr_off)]
        if kind == jpeg_color.KIND_444:
            cb, cr = (p[row0:row0 + n, col0:col0 + cols] for p in planes_cbcr)
        else:
            groups = (cols + 7) // 8
            c = np.arange(8 * groups)
            odd = c % 2 == 1
            j = c // 2 + 1  # staged position of the column's own sample
            jn = np.where(odd, j + 1, j - 1)
            cidx = np.clip(col0 // 2 - 1 + np.arange(4 * groups + 4), 0, cw - 1)
            first = row0 // 2 - 1 if kind == jpeg_color.KIND_420 else row0
            count = (n + 1) // 2 + 2 if kind == jpeg_color.KIND_420 else n
            ridx = np.clip(first + np.arange(count), 0, ch - 1)
            up = []
            for p in planes_cbcr:
                staged = p[ridx][:, cidx]
                tile = np.empty((n, 8 * groups), np.int64)
                for r in range(n):
                    if kind == jpeg_color.KIND_420:
                        own = staged[r // 2 + 1]
                        if cw <= 2:
                            tile[r] = own[j]
                            continue
                        sums = 3 * own + staged[r // 2 + (2 if r % 2 else 0)]
                        tile[r] = (3 * sums[j] + sums[jn] + np.where(odd, 7, 8)) >> 4
                    else:
                        own = staged[r]
                        tile[r] = own[j] if cw <= 2 else (
                            3 * own[j] + own[jn] + np.where(odd, 2, 1)) >> 2
                up.append(tile[:, :cols])
            cb, cr = up
        rgb = np.stack([y + ((91881 * cr - 11728000) >> 16),
                        y + ((8910336 - 22554 * cb - 46802 * cr) >> 16),
                        y + ((116130 * cb - 14831872) >> 16)], -1)
        out[off + 3 * at[..., None] + np.arange(3)] = np.clip(rgb, 0, 255)
    return torch.from_numpy(out)


@pytest.mark.parametrize("case", sorted(JPEG_COLOR_CASES))
def test_kernel_tiling_equals_plain_on_the_edge_cases(case):
    planes, layout, out_bytes = jpeg_color_case(case)
    want = color_kernel.ycc_to_rgb(planes, layout, out_bytes)  # the CPU: plain
    assert torch.equal(_tiles_like_the_kernel(planes, layout, out_bytes), want)


def test_edge_cases_put_planes_at_every_alignment():
    offsets = np.concatenate([jpeg_color_case(c)[1].numpy()[:, :3].ravel()
                              for c in JPEG_COLOR_CASES])
    assert set(offsets % 16) == set(range(16))


def test_kernel_launch_checks_its_table_and_output():
    """``kernels/jpeg_color.py:launch`` (the kernel on a table already on
    the card) refuses a table or an output the kernel would misread, before
    anything is launched."""
    planes, layout, out_bytes = jpeg_color_case("single_420")
    table, tiles = color_kernel.tile_table(layout.numpy())
    assert tiles == len(color_kernel.bands(layout.numpy()))
    good, out = torch.from_numpy(table), torch.empty(out_bytes, dtype=torch.uint8)
    before = profiling.counters().get("jpeg_color.launches", 0)
    for bad in (good[:-1], good.int(), good.float()):
        with pytest.raises(ValueError, match="table"):
            color_kernel.launch(planes, bad, len(layout), tiles, out)
    with pytest.raises(ValueError, match="table"):
        color_kernel.launch(planes, good, len(layout), tiles + 1, out)
    with pytest.raises(ValueError, match="out"):
        color_kernel.launch(planes, good, len(layout), tiles, out.int())
    assert profiling.counters().get("jpeg_color.launches", 0) == before
