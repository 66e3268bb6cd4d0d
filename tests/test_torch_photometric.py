"""The port's photometric transforms against the JAX package's, which run
OpenCV.

The colour conversions, the LUT and the histogram equalisation are NumPy
reproductions of OpenCV's own arithmetic (``ssd_keras_torch/data/
photometric.py``): uint8 RGB->HSV, HSV->RGB and RGB->GRAY, ``cv2.LUT`` and
``cv2.equalizeHist`` must equal OpenCV bit for bit; the float32 forms are
held within 1e-4 (H in degrees, S in [0, 1], V and gray in the input's
range; OpenCV's vector code divides and sums in another order, a few
float32 ulps); uint16 RGB->GRAY equals OpenCV bit for bit. The ``Random*`` forms must draw the same parameters from the
same ``np.random`` state, so the outputs and the state after the call are
equal. Images are seeded uint8 at three sizes, one of them with a width that
leaves a remainder past OpenCV's 32-pixel vector blocks.
"""

import cv2
import numpy as np
import pytest
import torch

from ssd_keras_tpu.data import photometric as J
from ssd_keras_torch.data import photometric as P

torch.set_num_threads(2)

SIZES = [(37, 53), (64, 64), (96, 127)]
FLOAT_TOL = 1e-4


def _image(shape, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    img[0, : min(8, shape[1])] = 128  # gray pixels: S = 0, H undefined
    img[1, :3] = [[255, 0, 0], [0, 255, 0], [0, 0, 255]]
    return img


def _hsv(shape, seed=1):
    rng = np.random.RandomState(seed)
    hsv = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    hsv[..., 0] = rng.randint(0, 181, shape)  # a rounded H can reach 180
    return hsv


@pytest.mark.parametrize("shape", SIZES)
@pytest.mark.parametrize("current, to", [("RGB", "HSV"), ("HSV", "RGB"), ("RGB", "GRAY"),
                                         ("HSV", "GRAY")])
def test_convert_color_uint8_equals_opencv(shape, current, to):
    image = _image(shape) if current == "RGB" else _hsv(shape)
    for keep_3ch in (True, False):
        expected = J.ConvertColor(current, to, keep_3ch)(image.copy())
        got = P.ConvertColor(current, to, keep_3ch)(image.copy())
        assert got.dtype == expected.dtype == np.uint8
        np.testing.assert_array_equal(got, expected)


def test_hsv_to_rgb_equals_opencv_on_every_triple():
    """Every (H, S) with H < 256, at 16 values of V, through OpenCV's vector
    loop (rows of 256 pixels) and through its scalar loop (the last 8 pixels
    of rows of 40)."""
    h, s, v = np.meshgrid(np.arange(256), np.arange(256), np.arange(0, 256, 17), indexing="ij")
    triples = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 3)
    vector = triples.reshape(-1, 256, 3)
    np.testing.assert_array_equal(P.cvt_color(vector, "HSV", "RGB"),
                                  cv2.cvtColor(vector, cv2.COLOR_HSV2RGB))
    tail = np.concatenate([np.zeros((len(triples) // 8, 32, 3), np.uint8),
                           triples.reshape(-1, 8, 3)], axis=1)
    np.testing.assert_array_equal(P.cvt_color(tail, "HSV", "RGB")[:, 32:],
                                  cv2.cvtColor(tail, cv2.COLOR_HSV2RGB)[:, 32:])


@pytest.mark.parametrize("shape", SIZES)
@pytest.mark.parametrize("current, to", [("RGB", "HSV"), ("HSV", "RGB"), ("RGB", "GRAY")])
def test_convert_color_float32_within_ulps_of_opencv(shape, current, to):
    rng = np.random.RandomState(2)
    image = rng.rand(*shape, 3).astype(np.float32)
    if current == "HSV":
        image[..., 0] *= 360.0
    else:
        image *= 255.0
    expected = J.ConvertColor(current, to, keep_3ch=False)(image.copy())
    got = P.ConvertColor(current, to, keep_3ch=False)(image.copy())
    assert got.dtype == np.float32 and got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=FLOAT_TOL, atol=FLOAT_TOL)


@pytest.mark.parametrize("width", [31, 32, 33, 65, 256])
def test_rgb_to_gray_uint16_equals_opencv(width):
    """OpenCV's 15-bit weights, as for uint8, over the whole uint16 range,
    in its vector blocks and its scalar tail; each channel alone at every
    value too."""
    image = np.random.RandomState(width).randint(0, 65536, (7, width, 3)).astype(np.uint16)
    image[0, :3] = 65535
    want = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
    for fn in (P.cvt_color, P.cvt_color_numpy):
        got = fn(image, "RGB", "GRAY")
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
    ramp = np.zeros((3, 65536, 3), np.uint16)
    for ch in range(3):
        ramp[ch, :, ch] = np.arange(65536)
    ramp = ramp.reshape(-1, 256, 3)
    np.testing.assert_array_equal(P.cvt_color(ramp, "RGB", "GRAY"),
                                  cv2.cvtColor(ramp, cv2.COLOR_RGB2GRAY))


def test_cvt_color_rejects_other_types_and_shapes():
    with pytest.raises(TypeError, match="uint8 or float32"):
        P.cvt_color(np.zeros((4, 4, 3), np.float64), "RGB", "HSV")
    # cv2 converts uint16 to GRAY alone, and int16 not at all.
    for dtype, to in ((np.uint16, "HSV"), (np.int16, "GRAY"), (np.float64, "GRAY")):
        image = np.zeros((4, 4, 3), dtype)
        with pytest.raises(cv2.error):
            cv2.cvtColor(image, cv2.COLOR_RGB2HSV if to == "HSV" else cv2.COLOR_RGB2GRAY)
        with pytest.raises(TypeError):
            P.cvt_color(image, "RGB", to)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        P.cvt_color(np.zeros((4, 4), np.uint8), "RGB", "HSV")
    with pytest.raises(NotImplementedError):
        P.ConvertColor("GRAY", "RGB")


@pytest.mark.parametrize("shape", SIZES)
def test_gamma_lut_and_histogram_equalisation_equal_opencv(shape):
    image = _image(shape, seed=3)
    for gamma in (0.4, 1.0, 1.7):
        np.testing.assert_array_equal(P.Gamma(gamma)(image.copy()), J.Gamma(gamma)(image.copy()))
    for lo, hi in ((0, 256), (40, 200), (100, 101)):  # full, narrow, one level
        hsv = image.copy()
        hsv[..., 2] = np.random.RandomState(lo).randint(lo, hi, shape)
        np.testing.assert_array_equal(P.HistogramEqualization()(hsv.copy()),
                                      J.HistogramEqualization()(hsv.copy()))
        np.testing.assert_array_equal(P.equalize_hist(hsv[..., 2]), cv2.equalizeHist(hsv[..., 2]))


def _float_image(shape):
    return _image(shape, seed=4).astype(np.float32)


DETERMINISTIC = {
    "ConvertDataType_uint8": (lambda m: m.ConvertDataType("uint8"),
                              lambda s: _float_image(s) + 0.5),
    "ConvertDataType_float32": (lambda m: m.ConvertDataType("float32"), _image),
    "ConvertTo3Channels_gray": (lambda m: m.ConvertTo3Channels(), lambda s: _image(s)[..., 0]),
    "ConvertTo3Channels_rgba": (lambda m: m.ConvertTo3Channels(),
                                lambda s: np.concatenate([_image(s), _image(s)[..., :1]], -1)),
    "Hue": (lambda m: m.Hue(-37.5), lambda s: _hsv(s).astype(np.float32)),
    "Saturation": (lambda m: m.Saturation(1.6), lambda s: _hsv(s).astype(np.float32)),
    "Brightness": (lambda m: m.Brightness(-20.25), _float_image),
    "Contrast": (lambda m: m.Contrast(1.3), _float_image),
    "ChannelSwap": (lambda m: m.ChannelSwap((2, 0, 1)), _image),
}


@pytest.mark.parametrize("shape", SIZES)
@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_transforms_equal_jax(name, shape):
    build, make = DETERMINISTIC[name]
    labels = np.array([[1, 2, 3, 10, 12]], np.float64)
    got_img, got_lab = build(P)(make(shape), labels.copy())
    exp_img, exp_lab = build(J)(make(shape), labels.copy())
    assert got_img.dtype == exp_img.dtype
    np.testing.assert_array_equal(got_img, exp_img)
    np.testing.assert_array_equal(got_lab, exp_lab)


RANDOM = {
    "RandomHue": (lambda m: m.RandomHue(18, prob=0.5), lambda s: _hsv(s).astype(np.float32)),
    "RandomSaturation": (lambda m: m.RandomSaturation(0.5, 1.5, prob=0.5),
                         lambda s: _hsv(s).astype(np.float32)),
    "RandomBrightness": (lambda m: m.RandomBrightness(-32, 32, prob=0.5), _float_image),
    "RandomContrast": (lambda m: m.RandomContrast(0.5, 1.5, prob=0.5), _float_image),
    "RandomGamma": (lambda m: m.RandomGamma(0.25, 2.0, prob=0.5), _image),
    "RandomHistogramEqualization": (lambda m: m.RandomHistogramEqualization(prob=0.5), _hsv),
    "RandomChannelSwap": (lambda m: m.RandomChannelSwap(prob=0.5), _image),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_transforms_draw_like_jax(name):
    """Eight calls under one seed a side: the same outputs (some applied,
    some not) and the same ``np.random`` state after."""
    build, make = RANDOM[name]
    outputs, states = {}, {}
    for side, module in (("jax", J), ("port", P)):
        np.random.seed(11)
        transform = build(module)
        outputs[side] = [transform(make((24, 33)), np.ones((1, 5)))[0] for _ in range(8)]
        states[side] = np.random.get_state()[1].copy()
    np.testing.assert_array_equal(states["port"], states["jax"])
    applied = 0
    for got, exp in zip(outputs["port"], outputs["jax"]):
        np.testing.assert_array_equal(got, exp)
        applied += not np.array_equal(got, make((24, 33)))
    assert 0 < applied < 8  # both branches of prob 0.5 were taken
