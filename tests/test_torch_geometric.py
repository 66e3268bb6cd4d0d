"""The port's geometric transforms against the JAX package's, which run
OpenCV (``cv2.resize``, ``cv2.warpAffine``, ``cv2.getRotationMatrix2D``).

Labels never depend on pixels: they must be equal bit for bit. Pixels, as
``ssd_keras_torch/data/geometric.py`` states for each: uint8 within one
level of OpenCV and equal on at least 99.9% of pixels (most are exact:
linear, nearest, area, Lanczos, integer translation, right-angle rotation);
``Translate`` and ``Flip`` bit-equal; float images within 1e-3 of a 0-255
range. Sizes go up, down, exactly 2x down and to odd shapes. ``Rotate`` is
held against OpenCV at odd and even sizes: its result is not ``np.rot90``.

Every image type OpenCV resizes and warps (uint8, uint16, int16, float32,
float64) at 1-4 channels is held to ``cv2`` as shipped, with IPP, and to
OpenCV's own code (``cv2.ipp.setUseIPP(False)``), cell by cell: exact, but
where IPP takes the cell (``IPP_LINEAR``, ``IPP_CUBIC``: within one level
for integers, ``IPP_FLOAT_TOL`` for floats) and on the warp's unrounded path
(uint8, uint16, float32 at 1, 3 or 4 channels: ``WARP_TAIL_TOL``, OpenCV's
scalar tail). The remap-path warp (float64, int16, 2 channels) is exact.
``INTER_NEAREST`` takes and keeps every type ``cv2.resize`` does.
"""

import contextlib

import random

import cv2
import numpy as np
import pytest
import torch

from ssd_keras_tpu.data import geometric as J
from ssd_keras_tpu.data.validation import BoxFilter as JaxBoxFilter
from ssd_keras_tpu.data.validation import ImageValidator as JaxImageValidator
from chip_smoke import IMAGE_OP_BORDERS, IMAGE_OP_RESIZES, image_op_noise
from ssd_keras_torch.data import geometric as P
from ssd_keras_torch.data.validation import BoxFilter, ImageValidator

torch.set_num_threads(2)

MODES = {"nearest": cv2.INTER_NEAREST, "linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC,
         "area": cv2.INTER_AREA, "lanczos4": cv2.INTER_LANCZOS4}
RESIZES = [((37, 53), (90, 120)), ((64, 64), (32, 32)), ((120, 90), (41, 17)),
           ((45, 60), (45, 128)), ((128, 96), (43, 32)), ((33, 47), (47, 33))]
FLOAT_TOL = 1e-3
MIN_EQUAL = 0.999


def _image(shape, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]] / max(shape)
    base = np.stack([np.sin(7 * xx + c) * np.cos(5 * yy - c) for c in range(3)], -1) * 100 + 128
    return np.clip(base + rng.randn(*shape, 3) * 30, 0, 255).astype(np.uint8)


def _labels(shape, seed=0, n=5):
    rng = np.random.RandomState(seed)
    h, w = shape
    x0 = rng.randint(0, w - 3, n)
    y0 = rng.randint(0, h - 3, n)
    x1 = np.minimum(x0 + rng.randint(2, w // 2 + 3, n), w - 1)
    y1 = np.minimum(y0 + rng.randint(2, h // 2 + 3, n), h - 1)
    return np.stack([rng.randint(1, 21, n), x0, y0, x1, y1], 1).astype(np.float64)


def _assert_pixels(got, expected, exact=False):
    assert got.shape == expected.shape and got.dtype == expected.dtype
    if exact:
        np.testing.assert_array_equal(got, expected)
    elif got.dtype == np.uint8:
        diff = np.abs(got.astype(int) - expected.astype(int))
        assert diff.max() <= 1, diff.max()
        assert (diff == 0).mean() >= MIN_EQUAL, (diff == 0).mean()
    else:
        np.testing.assert_allclose(got, expected, rtol=0, atol=FLOAT_TOL)


@pytest.mark.parametrize("src, dst", RESIZES)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_resize_modes_equal_opencv(mode, src, dst):
    image, labels = _image(src), _labels(src)
    flag = MODES[mode]
    got_img, got_lab, got_inv = P.Resize(*dst, interpolation_mode=flag)(
        image, labels, return_inverter=True)
    exp_img, exp_lab, exp_inv = J.Resize(*dst, interpolation_mode=flag)(
        image, labels, return_inverter=True)
    np.testing.assert_array_equal(got_lab, exp_lab)
    preds = np.concatenate([np.ones((5, 1)), np.full((5, 1), 0.5), labels[:, 1:] * 0.77], 1)
    np.testing.assert_array_equal(got_inv(preds), exp_inv(preds))
    _assert_pixels(got_img, exp_img, exact=mode in ("nearest", "linear", "area", "lanczos4"))
    f = image.astype(np.float32)
    _assert_pixels(P.resize_image(f, *dst, flag), cv2.resize(f, dst[::-1], interpolation=flag))


def test_resize_one_channel_and_the_area_fast_path():
    image = _image((96, 120))
    for gray in (image[..., 0], image[..., :1]):
        for flag in MODES.values():
            got = P.resize_image(gray, 31, 45, flag)
            assert got.shape == (31, 45)
            _assert_pixels(got, cv2.resize(gray, (45, 31), interpolation=flag))
    for dst in ((32, 40), (24, 30), (48, 40)):  # 3x, 4x, and 2x by 3x blocks
        np.testing.assert_array_equal(P.resize_image(image, *dst, P.INTER_AREA),
                                      cv2.resize(image, dst[::-1], interpolation=cv2.INTER_AREA))


def test_resize_random_interp_draws_like_jax():
    image, labels = _image((50, 70)), _labels((50, 70))
    for seed in range(6):
        outs = []
        for module in (J, P):
            np.random.seed(seed)
            outs.append(module.ResizeRandomInterp(40, 30)(image, labels))
            outs.append(np.random.get_state()[1][:4].copy())
        np.testing.assert_array_equal(outs[1], outs[3])
        np.testing.assert_array_equal(outs[2][1], outs[0][1])
        _assert_pixels(outs[2][0], outs[0][0])


@pytest.mark.parametrize("dim", ["horizontal", "vertical"])
def test_flip_is_exact(dim):
    image, labels = _image((31, 46)), _labels((31, 46))
    got = P.Flip(dim)(image, labels)
    exp = J.Flip(dim)(image, labels)
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(got[1], exp[1])
    np.random.seed(3)
    a = [P.RandomFlip(dim)(image, labels) for _ in range(6)]
    np.random.seed(3)
    b = [J.RandomFlip(dim)(image, labels) for _ in range(6)]
    for (gi, gl), (ei, el) in zip(a, b):
        np.testing.assert_array_equal(gi, ei)
        np.testing.assert_array_equal(gl, el)


@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (45, 30)])
@pytest.mark.parametrize("dy, dx", [(0.1, -0.2), (-0.33, 0.05), (0.5, 0.5)])
def test_translate_is_exact(shape, dy, dx):
    image, labels = _image(shape), _labels(shape)
    for background in ((0, 0, 0), (123, 117, 104)):
        got = P.Translate(dy, dx, background=background)(image, labels)
        exp = J.Translate(dy, dx, background=background)(image, labels)
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])


@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (45, 30)])
@pytest.mark.parametrize("factor", [0.55, 0.8, 1.3, 1.91])
def test_scale_within_one_level(shape, factor):
    image, labels = _image(shape), _labels(shape)
    for background in ((0, 0, 0), (123, 117, 104)):
        got = P.Scale(factor, background=background)(image, labels)
        exp = J.Scale(factor, background=background)(image, labels)
        _assert_pixels(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])
    f = image.astype(np.float32)
    _assert_pixels(P.Scale(factor)(f), J.Scale(factor)(f))


@pytest.mark.parametrize("shape", [(7, 10), (8, 8), (9, 9), (37, 53), (64, 48)])
@pytest.mark.parametrize("angle", [90, 180, 270])
def test_rotate_equals_opencv_not_rot90(shape, angle):
    image, labels = _image(shape), _labels(shape, n=3)
    got = P.Rotate(angle)(image, labels)
    exp = J.Rotate(angle)(image, labels)
    _assert_pixels(got[0], exp[0])
    np.testing.assert_array_equal(got[1], exp[1])
    assert not np.array_equal(exp[0], np.rot90(image, angle // 90))


def test_rotation_matrix_and_warp_equal_opencv():
    for center, angle, scale in [((26.5, 18.5), 0, 1.3), ((5.0, 3.5), 90, 1), ((33.5, 12.0), 180, 1),
                                 ((10, 7), 30, 0.731)]:
        np.testing.assert_array_equal(P.rotation_matrix_2d(center, angle, scale),
                                      cv2.getRotationMatrix2D(center, angle, scale))
    image = _image((40, 50))
    m = cv2.getRotationMatrix2D((25, 20), 17, 0.9)
    _assert_pixels(P.warp_affine(image, m, (60, 35)), cv2.warpAffine(image, m, (60, 35)))
    _assert_pixels(P.warp_affine(image[..., 0], m, (60, 35), 7),
                   cv2.warpAffine(image[..., 0], m, (60, 35), borderValue=7))


def _trial_kwargs(module_validation):
    box_filter, validator = module_validation
    return dict(box_filter=box_filter(check_overlap=True, check_min_area=False,
                                      check_degenerate=False, overlap_criterion="area",
                                      overlap_bounds=(0.3, 1.0)),
                image_validator=validator(overlap_criterion="area", bounds=(0.5, 1.0),
                                          n_boxes_min=1))


RANDOM = {
    "RandomTranslate": lambda m, v: m.RandomTranslate((0.03, 0.5), (0.03, 0.5), prob=0.5,
                                                      **_trial_kwargs(v)),
    "RandomScale_in": lambda m, v: m.RandomScale(1.0, 2.0, prob=0.5, **_trial_kwargs(v)),
    "RandomScale_out": lambda m, v: m.RandomScale(0.5, 1.0, prob=0.5, **_trial_kwargs(v)),
    "RandomRotate": lambda m, v: m.RandomRotate((90, 180, 270), prob=0.5),
}


@pytest.mark.parametrize("shape", [(37, 53), (48, 48)])
@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_geometric_transforms_draw_like_jax(name, shape):
    """Ten calls under one seed a side (``np.random`` and ``random``): labels
    equal bit for bit, pixels within one level, and the same random state
    after."""
    image = _image(shape)
    results, states = {}, {}
    for side, module, validation in (("jax", J, (JaxBoxFilter, JaxImageValidator)),
                                     ("port", P, (BoxFilter, ImageValidator))):
        np.random.seed(5)
        random.seed(5)
        transform = RANDOM[name](module, validation)
        results[side] = [transform(image, _labels(shape, seed=i)) for i in range(10)]
        states[side] = (np.random.get_state()[1].copy(), random.getstate())
    np.testing.assert_array_equal(states["port"][0], states["jax"][0])
    assert states["port"][1] == states["jax"][1]
    changed = 0
    for (gi, gl), (ei, el) in zip(results["port"], results["jax"]):
        np.testing.assert_array_equal(gl, el)
        _assert_pixels(gi, ei)
        changed += gi.shape != image.shape or not np.array_equal(gi, image)
    assert changed > 0


# --------------------------------------------------------------------------- #
# Every image type against cv2, with IPP (as shipped) and without
# --------------------------------------------------------------------------- #

TYPES = [np.uint8, np.uint16, np.int16, np.float32, np.float64]
WARP_MAPS = {"shift": np.array([[1, 0, 3.3], [0, 1, -2.6]]),
             "rotation": cv2.getRotationMatrix2D((20.3, 15.7), 17, 1.1),
             "scale": np.array([[0.77, 0, 1.9], [0, 1.31, -0.4]])}
# The cells cv2.resize hands to IPP at 1, 3 or 4 channels.
IPP_LINEAR = (np.uint16, np.int16, np.float32, np.float64)
IPP_CUBIC = (np.uint8, np.uint16, np.int16, np.float32)
# There: one level for the integer types, this for floats on [-20, 280).
IPP_FLOAT_TOL = 2e-3
# The unrounded warp's scalar tail (the last width % 16 pixels of a row),
# where OpenCV rounds the source position otherwise.
WARP_TAIL_TOL = {np.uint8: 1, np.uint16: 1, np.float32: 2e-3}


@contextlib.contextmanager
def _ipp(on):
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(on)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(before)


def _within(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() <= tol, (diff.max(), tol)


@pytest.mark.parametrize("border", sorted(IMAGE_OP_BORDERS))
@pytest.mark.parametrize("warp", sorted(WARP_MAPS))
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", TYPES, ids=lambda d: np.dtype(d).name)
def test_warp_affine_every_type_against_opencv(dtype, channels, warp, border):
    image = image_op_noise(np.random.RandomState(channels), (37, 53, channels), dtype)
    m, value = WARP_MAPS[warp], IMAGE_OP_BORDERS[border]
    remap = dtype in (np.int16, np.float64) or channels == 2
    for dsize in [(60, 45), (50, 41)]:
        got = P.warp_affine(image, m, dsize, value)
        np.testing.assert_array_equal(got, P.warp_affine_numpy(image, m, dsize, value))
        for ipp in (True, False):  # IPP takes no warp
            with _ipp(ipp):
                want = cv2.warpAffine(image, m, dsize, borderValue=value)
            _within(got, want, 0 if remap else WARP_TAIL_TOL[dtype])


def test_warp_border_is_saturated_to_the_image_type():
    """A fractional or out-of-range border takes OpenCV's saturate_cast on
    both paths (7.5 -> 8, 8.5 -> 8, -3.2 -> 0, 70000 -> 255 for uint8)."""
    value = (7.5, 8.5, -3.2, 70000)
    for dtype in (np.uint8, np.uint16, np.int16):
        for channels in (2, 3, 4):
            image = image_op_noise(np.random.RandomState(9), (37, 53, channels), dtype)
            for m in WARP_MAPS.values():
                got = P.warp_affine(image, m, (60, 45), value)
                _within(got, cv2.warpAffine(image, m, (60, 45), borderValue=value),
                        0 if channels == 2 or dtype == np.int16 else 1)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", TYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_resize_every_type_against_opencv(mode, dtype, channels):
    flag = MODES[mode]
    ipp_cell = channels != 2 and (mode == "linear" and dtype in IPP_LINEAR
                                  or mode == "cubic" and dtype in IPP_CUBIC)
    tol = IPP_FLOAT_TOL if np.dtype(dtype).kind == "f" else 1
    for case, (src, dst) in IMAGE_OP_RESIZES.items():
        image = image_op_noise(np.random.RandomState(len(case) + channels), (*src, channels),
                               dtype)
        got = P.resize_image(image, *dst, flag)
        np.testing.assert_array_equal(got, P.resize_image_numpy(image, *dst, flag))
        with _ipp(True):
            shipped = cv2.resize(image, dst[::-1], interpolation=flag)
        with _ipp(False):
            own = cv2.resize(image, dst[::-1], interpolation=flag)
        _within(got, shipped, tol if ipp_cell else 0)
        # OpenCV's own code: exact but in IPP's cubic cells, which keep
        # the sum that comes nearest IPP's.
        _within(got, own, tol if ipp_cell and mode == "cubic" else 0)


@pytest.mark.parametrize("dtype", [np.int8, np.uint32, np.int32, np.int64, np.uint64, np.bool_,
                                   np.float16], ids=lambda d: np.dtype(d).name)
def test_nearest_takes_the_types_opencv_takes(dtype):
    """cv2.resize takes these in INTER_NEAREST alone (int64 and uint64 come
    back int32, wrapped, from its binding); the other modes raise."""
    for case, (src, dst) in IMAGE_OP_RESIZES.items():
        for channels in (1, 3):
            image = image_op_noise(np.random.RandomState(len(case)), (*src, channels), dtype)
            want = cv2.resize(image, dst[::-1], interpolation=cv2.INTER_NEAREST)
            got = P.resize_image(image, *dst, P.INTER_NEAREST)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(P.resize_image_numpy(image, *dst, P.INTER_NEAREST), want)
    if dtype == np.float16:
        return  # the port resizes float16 in every mode (NumPy); OpenCV refuses
    image = image_op_noise(np.random.RandomState(0), (9, 11, 3), dtype)
    for mode in ("linear", "cubic", "area", "lanczos4"):
        with pytest.raises(cv2.error):
            cv2.resize(image, (7, 5), interpolation=MODES[mode])
        with pytest.raises(NotImplementedError):
            P.resize_image(image, 5, 7, MODES[mode])


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.uint32, np.bool_],
                         ids=lambda d: np.dtype(d).name)
def test_warp_refuses_the_types_opencv_refuses(dtype):
    image = image_op_noise(np.random.RandomState(0), (9, 11, 3), dtype)
    with pytest.raises(cv2.error):
        cv2.warpAffine(image, WARP_MAPS["shift"], (7, 5))
    with pytest.raises(NotImplementedError):
        P.warp_affine(image, WARP_MAPS["shift"], (7, 5))


def test_single_channel_images_come_back_two_dimensional():
    """An (H, W, 1) image comes back (h, w) from either op, as from cv2."""
    image = image_op_noise(np.random.RandomState(0), (37, 53, 1), np.uint16)
    for m in WARP_MAPS.values():
        got = P.warp_affine(image, m, (60, 45))
        want = cv2.warpAffine(image, m, (60, 45))
        assert got.shape == want.shape == (45, 60)
    assert P.resize_image(image, 20, 30).shape == cv2.resize(image, (30, 20)).shape == (20, 30)


@pytest.mark.parametrize("dtype", TYPES, ids=lambda d: np.dtype(d).name)
def test_warp_of_five_channels_against_opencv(dtype):
    """Past four channels every type takes the remap path; channel k takes
    the border's value k & 3."""
    image = image_op_noise(np.random.RandomState(5), (37, 53, 5), dtype)
    for m in WARP_MAPS.values():
        value = (10, 200, 30, 77)
        _within(P.warp_affine(image, m, (60, 45), value),
                cv2.warpAffine(image, m, (60, 45), borderValue=value), 0)


def test_opencv_parity_report(tmp_path):
    """``examples.opencv_parity`` measured on this checkout in a child
    process (``--tree``): no cell raises, the remap-path warps and the
    cells outside IPP's are exact, IPP's within the tolerances above."""
    from pathlib import Path

    from ssd_keras_torch.examples import opencv_parity

    repo = Path(__file__).resolve().parent.parent
    out = tmp_path / "parity.md"
    result = opencv_parity.main(["--tree", str(repo), "--out", str(out)])
    assert out.read_text().startswith("# The host image ops against OpenCV")
    for table in result.values():
        for cell, by_ipp in table.items():
            assert not any(isinstance(v, str) for v in by_ipp.values()), (cell, by_ipp)
    for cell, d in result["warp"].items():
        dtype, channels = cell.split(" x")
        if dtype in ("int16", "float64") or channels == "2":
            assert d == {"ipp": 0, "no_ipp": 0}, cell
    for cell, d in result["resize"].items():
        dtype, rest = cell.split(" x")
        channels, mode = rest.split(" ")
        ipp_cell = channels != "2" and (
            mode == "linear" and dtype in ("uint16", "int16", "float32", "float64")
            or mode == "cubic" and dtype in ("uint8", "uint16", "int16", "float32"))
        tol = IPP_FLOAT_TOL if dtype.startswith("float") else 1
        assert d["ipp"] <= (tol if ipp_cell else 0), cell
    assert result["gray_uint16"]["RGB->GRAY"] == {"ipp": 0, "no_ipp": 0}
