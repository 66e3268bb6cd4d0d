"""The host C++ of the augmentation chains (``ssd_keras_torch/native/
ssd_image_ops.cpp``) against its plain NumPy versions, and the chains
through it against the JAX package's, which run OpenCV.

Each native op must equal its plain version bit for bit (``np.array_equal``
on the same dtype and shape): ``resize_image`` against
``resize_image_numpy`` in all five modes for uint8, uint16, int16, float32
and float64 on 1, 2 and 3 channels, up and down, to and from one pixel, at
odd sizes, exact 2x, integer area factors (3x, 4x) and non-integer area
shrinks, and in ``INTER_NEAREST`` for int8, uint32, int32 and bool;
``cvt_color`` against ``cvt_color_numpy`` all three ways for uint8 and
float32 at widths 31, 32, 33 and 65 (the uint8 HSV->RGB rounds the last
``width % 32`` pixels of a row and truncates the others) and RGB->GRAY for
uint16; ``warp_affine`` against ``warp_affine_numpy`` for integer
translation, scale, right-angle and arbitrary rotation with a zero and a
non-zero border, on both of OpenCV's paths (the remap path: float64, int16,
2 and 5 channels). Inputs come from
a numpy seed. Each chain run through the native ops gives the images and
labels it gives with the plain functions patched in, and
``SSDDataAugmentation`` stays within the one level of OpenCV that
``tests/test_torch_chains.py`` allows, with labels bit-equal.
"""

import random
import shutil

import numpy as np
import pytest
import torch

# The fixtures chip_smoke.py's phase 10 holds on the card's host too.
from chip_smoke import IMAGE_OP_BORDERS as BORDERS
from chip_smoke import IMAGE_OP_CVT as CVT
from chip_smoke import IMAGE_OP_CVT_WIDTHS as CVT_WIDTHS
from chip_smoke import IMAGE_OP_MODES as MODES
from chip_smoke import IMAGE_OP_RESIZES as RESIZES  # (source (h, w), destination (h, w))
from chip_smoke import IMAGE_OP_WARP_SHAPE as WARP_SHAPE
from chip_smoke import IMAGE_OP_WARPS as WARPS
from chip_smoke import image_op_noise
from ssd_keras_tpu.data import chains as J
from ssd_keras_torch import native
from ssd_keras_torch.data import SynthVOC
from ssd_keras_torch.data import chains as P
from ssd_keras_torch.data import geometric as G
from ssd_keras_torch.data import photometric as PH
from ssd_keras_torch.native import image_ops

torch.set_num_threads(2)

DTYPES = [np.uint8, np.float32, np.float64, np.uint16, np.int16]
CHANNELS = [1, 2, 3]
# tests/test_torch_chains.py's gate on the chains against OpenCV.
MAX_DIFF = 1
MIN_EQUAL = 0.999
CHAINS = {
    "SSDDataAugmentation": lambda m: m.SSDDataAugmentation(300, 300),
    "DataAugmentationConstantInputSize": lambda m: m.DataAugmentationConstantInputSize(),
    "DataAugmentationVariableInputSize": lambda m: m.DataAugmentationVariableInputSize(300, 300),
    "DataAugmentationSatellite": lambda m: m.DataAugmentationSatellite(300, 300),
}


def _image(shape, dtype, seed=0):
    return image_op_noise(np.random.RandomState(seed), shape, dtype)


def _assert_same(got, expected):
    assert got.dtype == expected.dtype and got.shape == expected.shape
    assert np.array_equal(got, expected), np.abs(got.astype(float) - expected).max()


def _calls():
    return dict(native.image_ops_calls)


# --------------------------------------------------------------------------- #
# Each op against its plain version
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(RESIZES))
def test_resize_equals_numpy(case, mode, dtype, channels):
    src, dst = RESIZES[case]
    image = _image((*src, channels), dtype, seed=len(case) + channels)
    _assert_same(G.resize_image(image, *dst, MODES[mode]),
                 G.resize_image_numpy(image, *dst, MODES[mode]))


@pytest.mark.parametrize("mode", ["lanczos4", "cubic"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_kernels_at_the_edges_equal_numpy(mode, dtype):
    """A checkerboard of the range's ends under an edge-to-edge ramp: the
    clamped taps overshoot most at the border, and uint8 Lanczos's integer
    sums reach their extremes."""
    hi = 255 if dtype == np.uint8 else 300
    yy, xx = np.mgrid[0:23, 0:29]
    board = np.where((yy + xx) % 2 == 0, hi, 0)
    image = np.stack([board, board[::-1], xx * hi // 28], -1).astype(dtype)
    for dst in [(7, 9), (23, 60), (61, 17), (1, 29)]:
        _assert_same(G.resize_image(image, *dst, MODES[mode]),
                     G.resize_image_numpy(image, *dst, MODES[mode]))


def test_resize_views_and_squeeze_equal_numpy():
    """A flipped view (not contiguous), an (H, W) and an (H, W, 1) image:
    the native route copies what it must and squeezes as OpenCV does."""
    image = _image((40, 50, 3), np.uint8)
    _assert_same(G.resize_image(image[:, ::-1], 30, 70), G.resize_image_numpy(image[:, ::-1], 30, 70))
    for plane in (image[..., 0], image[..., :1]):
        got = G.resize_image(plane, 19, 23, G.INTER_CUBIC)
        assert got.shape == (19, 23)
        _assert_same(got, G.resize_image_numpy(plane, 19, 23, G.INTER_CUBIC))


@pytest.mark.parametrize("width", CVT_WIDTHS)
def test_cvt_color_uint16_gray_equals_numpy(width):
    image = _image((5, width, 3), np.uint16, seed=width)
    got = PH.cvt_color(image, "RGB", "GRAY")
    assert got.dtype == np.uint16 and got.shape == (5, width)
    _assert_same(got, PH.cvt_color_numpy(image, "RGB", "GRAY"))


@pytest.mark.parametrize("dtype", [np.int8, np.uint32, np.int32, np.bool_],
                         ids=lambda d: np.dtype(d).name)
def test_nearest_of_other_types_equals_numpy(dtype):
    """A gather by item size: the native route takes every type cv2.resize
    keeps in INTER_NEAREST."""
    before = _calls()
    for case, (src, dst) in sorted(RESIZES.items()):
        image = _image((*src, 3), dtype, seed=len(case))
        _assert_same(G.resize_image(image, *dst, G.INTER_NEAREST),
                     G.resize_image_numpy(image, *dst, G.INTER_NEAREST))
    assert _calls()["resize"] == before["resize"] + sum(
        src != dst for src, dst in RESIZES.values())


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_warp_of_five_channels_equals_numpy(dtype):
    """Past four channels every type takes the remap path, channel k the
    border's value k & 3."""
    image = _image((*WARP_SHAPE, 5), dtype, seed=5)
    for m in WARPS.values():
        for border in BORDERS.values():
            _assert_same(G.warp_affine(image, m, (50, 41), border),
                         G.warp_affine_numpy(image, m, (50, 41), border))


@pytest.mark.parametrize("width", CVT_WIDTHS)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("current, to", CVT)
def test_cvt_color_equals_numpy(current, to, dtype, width):
    rng = np.random.RandomState(width)
    image = rng.randint(0, 256, (5, width, 3)).astype(dtype)
    if dtype == np.float32:
        image = image + rng.rand(5, width, 3).astype(np.float32)
    if current == "HSV":
        image = PH.cvt_color_numpy(image, "RGB", "HSV")
        if dtype == np.float32:  # hue past both ends of [0, 360)
            image = image * np.float32([1.7, 1, 1]) - np.float32([200, 0, 0])
    _assert_same(PH.cvt_color(image, current, to), PH.cvt_color_numpy(image, current, to))


def test_cvt_color_uint8_equals_numpy_on_every_triple():
    """Every uint8 triple through RGB->HSV, RGB->GRAY and HSV->RGB, in rows
    of 96 pixels (three vector blocks) and of 67 (a 3-pixel rounded tail)."""
    v = np.arange(256, dtype=np.uint8)
    triples = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)
    for width in (96, 67):
        n = len(triples) // width * width
        image = np.ascontiguousarray(triples[:n].reshape(-1, width, 3))
        for current, to in CVT:
            _assert_same(PH.cvt_color(image, current, to), PH.cvt_color_numpy(image, current, to))


@pytest.mark.parametrize("border", sorted(BORDERS))
@pytest.mark.parametrize("warp", sorted(WARPS))
@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_warp_affine_equals_numpy(dtype, channels, warp, border):
    image = _image((*WARP_SHAPE, channels), dtype, seed=channels)
    if channels == 1:
        image = image[..., 0]
    m = WARPS[warp]
    for dsize in [(WARP_SHAPE[1], WARP_SHAPE[0]), (WARP_SHAPE[0] + 4, WARP_SHAPE[1] - 3)]:
        _assert_same(G.warp_affine(image, m, dsize, BORDERS[border]),
                     G.warp_affine_numpy(image, m, dsize, BORDERS[border]))


# --------------------------------------------------------------------------- #
# Routes, checks and the build
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_native_route_counts_each_op(dtype):
    image = _image((20, 24, 3), dtype)
    before = _calls()
    G.resize_image(image, 11, 13, G.INTER_AREA)
    G.warp_affine(image, WARPS["rotation"], (24, 20))
    gray = dtype in (np.uint8, np.float32, np.uint16)  # the types cv2 converts to GRAY
    if gray:
        PH.cvt_color(image.astype(dtype), "RGB", "GRAY")
    else:
        with pytest.raises(TypeError):
            PH.cvt_color(image, "RGB", "GRAY")
    after = _calls()
    assert after["resize"] == before["resize"] + 1
    assert after["warp_affine"] == before["warp_affine"] + 1
    assert after["cvt_color"] == before["cvt_color"] + gray


def test_float16_takes_the_numpy_route():
    image = _image((20, 24, 3), np.float16)
    before = _calls()
    for mode in MODES.values():
        got = G.resize_image(image, 11, 30, mode)
        assert got.dtype == np.float16
        _assert_same(got, G.resize_image_numpy(image, 11, 30, mode))
    got = G.warp_affine(image, WARPS["scale"], (24, 20))
    _assert_same(got, G.warp_affine_numpy(image, WARPS["scale"], (24, 20)))
    assert _calls() == before


def test_plain_versions_never_call_the_native_ops():
    image = _image((20, 24, 3), np.uint8)
    before = _calls()
    G.resize_image_numpy(image, 9, 9, G.INTER_LANCZOS4)
    G.warp_affine_numpy(image, WARPS["scale"], (24, 20))
    PH.cvt_color_numpy(image, "RGB", "HSV")
    assert _calls() == before


@pytest.fixture()
def no_c(monkeypatch):
    """Any call that reaches the library fails the test."""
    def refuse():
        raise AssertionError("the C library was reached")
    monkeypatch.setattr(image_ops, "load_image_ops", refuse)


BAD_CALLS = {
    "resize_2d_image": lambda u8, f32: image_ops.resize_separable(
        u8[..., 0], np.zeros((3, 4), np.int64), np.zeros((3, 4), np.float32),
        np.zeros((3, 4), np.int64), np.zeros((3, 4), np.float32)),
    "resize_int32_image": lambda u8, f32: image_ops.resize_block_mean(
        u8.astype(np.int32), 4, 5, 2, 2, True),
    "resize_float16_image": lambda u8, f32: image_ops.resize_nearest(
        f32.astype(np.float16), [0, 1], [0, 1]),
    "resize_not_contiguous": lambda u8, f32: image_ops.resize_nearest(u8[:, ::-1], [0], [0]),
    "resize_index_past_the_edge": lambda u8, f32: image_ops.resize_separable(
        f32, np.full((3, 4), 10, np.int64), np.zeros((3, 4), np.float32),
        np.zeros((3, 4), np.int64), np.zeros((3, 4), np.float32)),
    "resize_negative_index": lambda u8, f32: image_ops.resize_nearest(u8, [-1], [0]),
    "resize_weights_of_another_shape": lambda u8, f32: image_ops.resize_separable(
        f32, np.zeros((3, 4), np.int64), np.zeros((3, 3), np.float32),
        np.zeros((3, 4), np.int64), np.zeros((3, 4), np.float32)),
    "resize_lanczos_u8_of_floats": lambda u8, f32: image_ops.resize_fixed_u8(
        f32, np.zeros((3, 8), np.int64), np.zeros((3, 8), np.int32),
        np.zeros((3, 8), np.int64), np.zeros((3, 8), np.int32)),
    "resize_linear_u8_short_taps": lambda u8, f32: image_ops.resize_linear_u8(
        u8, ([0, 1], [1, 2], [1, 1], [1]), ([0], [1], [1], [1])),
    "blocks_past_the_image": lambda u8, f32: image_ops.resize_block_mean(u8, 5, 5, 2, 2, True),
    "halving_of_3x3_blocks": lambda u8, f32: image_ops.resize_block_mean(u8, 2, 2, 3, 3, True),
    "warp_map_of_another_shape": lambda u8, f32: image_ops.warp_affine(
        u8, np.zeros((2, 2), np.float32), np.zeros(3, np.float32), 5, 5),
    "warp_border_of_another_length": lambda u8, f32: image_ops.warp_affine(
        u8, np.zeros((2, 3), np.float32), np.zeros(4, np.float32), 5, 5),
    "warp_empty_output": lambda u8, f32: image_ops.warp_affine(
        f32, np.zeros((2, 3), np.float32), np.zeros(3, np.float32), 0, 5),
    "cvt_four_channels": lambda u8, f32: image_ops.cvt_color(
        np.zeros((4, 4, 4), np.uint8), "RGB", "HSV", PH._SDIV, PH._HDIV),
    "cvt_float64": lambda u8, f32: image_ops.cvt_color(
        f32.astype(np.float64), "RGB", "HSV", PH._SDIV, PH._HDIV),
    "cvt_short_table": lambda u8, f32: image_ops.cvt_color(
        u8, "RGB", "HSV", PH._SDIV[:255], PH._HDIV),
    "cvt_unknown_conversion": lambda u8, f32: image_ops.cvt_color(
        u8, "HSV", "GRAY", PH._SDIV, PH._HDIV),
    "empty_image": lambda u8, f32: image_ops.resize_nearest(u8[:0], [0], [0]),
}


@pytest.mark.parametrize("name", sorted(BAD_CALLS))
def test_shape_and_dtype_errors_raise_before_c(name, no_c):
    u8 = _image((8, 10, 3), np.uint8)
    with pytest.raises((ValueError, TypeError, KeyError)):
        BAD_CALLS[name](u8, u8.astype(np.float32))


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    image_ops.load_image_ops.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            G.resize_image(_image((8, 8, 3), np.uint8), 4, 4)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            PH.cvt_color(_image((8, 8, 3), np.uint8), "RGB", "HSV")
    finally:
        image_ops.load_image_ops.cache_clear()
    assert not (tmp_path / "_build").exists() or not list((tmp_path / "_build").iterdir())


def test_library_name_follows_source_and_every_flag(tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    names = {native._library_path(src).name,
             native._library_path(src, flags=("-ffp-contract=off",)).name,
             native._library_path(src, flags=("-ffp-contract=fast",)).name,
             native._library_path(src, libraries=("-ljpeg",)).name}
    assert len(names) == 4
    assert native._library_path(src, flags=("-DX",)) == native._library_path(src, flags=("-DX",))
    before = native._library_path(src, flags=("-DX",))
    src.write_text("int f() { return 2; }\n")
    assert native._library_path(src, flags=("-DX",)) != before
    lib = native._library_path(image_ops.IMAGE_OPS_SOURCE, flags=image_ops.IMAGE_OPS_FLAGS)
    assert lib.parent == native.BUILD_DIR and lib.name.startswith("libssd_image_ops_")
    assert "-ffp-contract=off" in native.gxx_command("g++", src, tmp_path / "l.so",
                                                     flags=image_ops.IMAGE_OPS_FLAGS)


# --------------------------------------------------------------------------- #
# The chains
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def split():
    images, labels = SynthVOC(6, image_size=300, split="train", seed=7).materialize()
    return images, [l.astype(np.float64) for l in labels]


def _run_chain(chain, images, labels, seed):
    out = []
    for i in range(len(images)):
        np.random.seed(seed + i)
        random.seed(seed + i)
        out.append(chain(images[i].copy(), labels[i].copy()))
    return out


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_native_equals_chain_with_plain_functions(name, split, monkeypatch):
    images, labels = split
    before = _calls()
    native_out = _run_chain(CHAINS[name](P), images, labels, 300)
    used = {op: _calls()[op] - before[op] for op in before}
    assert used["resize"] + used["warp_affine"] + used["cvt_color"] > 0, used
    monkeypatch.setattr(G, "resize_image", G.resize_image_numpy)
    monkeypatch.setattr(G, "warp_affine", G.warp_affine_numpy)
    monkeypatch.setattr(PH, "cvt_color", PH.cvt_color_numpy)
    before = _calls()
    plain_out = _run_chain(CHAINS[name](P), images, labels, 300)
    assert _calls() == before
    for i, ((img, lab), (exp_img, exp_lab)) in enumerate(zip(native_out, plain_out)):
        np.testing.assert_array_equal(lab, exp_lab, err_msg=f"{name} image {i}")
        _assert_same(img, exp_img)


def test_ssd_chain_native_against_jax_opencv(split):
    images, labels = split
    got = _run_chain(P.SSDDataAugmentation(300, 300), images, labels, 500)
    expected = _run_chain(J.SSDDataAugmentation(300, 300), images, labels, 500)
    for i, ((img, lab), (exp_img, exp_lab)) in enumerate(zip(got, expected)):
        np.testing.assert_array_equal(lab, exp_lab, err_msg=f"image {i}")
        assert img.shape == exp_img.shape and img.dtype == exp_img.dtype == np.uint8
        diff = np.abs(img.astype(int) - exp_img.astype(int))
        assert diff.max() <= MAX_DIFF, diff.max()
        assert (diff == 0).mean() >= MIN_EQUAL, (diff == 0).mean()
