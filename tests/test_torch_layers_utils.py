"""The small remainders of the port against the JAX package: the
``AnchorBoxes`` layer, ``convert_coordinates2`` and ``draw_detections``.

``AnchorBoxes`` must give the JAX layer's anchors and variances (float32,
from the same float64 grid, so bit for bit); ``convert_coordinates2`` is a
4x4 matrix product whose sums NumPy and torch order alike (1e-12 relative,
as tests/test_boxes.py holds the JAX function); ``draw_detections`` draws
with PIL on both sides and must give the same pixels.
"""

import jax
import numpy as np
import pytest
import torch

from ssd_keras_tpu.models.layers import AnchorBoxes as JaxAnchorBoxes
from ssd_keras_tpu.ops import boxes as jax_boxes
from ssd_keras_tpu.utils.visualization import draw_detections as jax_draw_detections
from ssd_keras_torch.models.layers import AnchorBoxes
from ssd_keras_torch.ops import boxes
from ssd_keras_torch.utils import draw_detections

torch.set_num_threads(2)

ANCHOR_CASES = {
    "ssd300_conv4_3": dict(img_height=300, img_width=300, this_scale=0.1, next_scale=0.2,
                           aspect_ratios=(1.0, 2.0, 0.5), this_steps=8, this_offsets=0.5),
    "corners_clipped": dict(img_height=96, img_width=128, this_scale=0.3, next_scale=0.5,
                            aspect_ratios=(0.5, 1.0, 2.0, 3.0), clip_boxes=True,
                            coords="corners", variances=(1.0, 1.0, 1.0, 1.0)),
    "minmax_pixels": dict(img_height=64, img_width=64, this_scale=0.5, next_scale=0.8,
                          two_boxes_for_ar1=False, coords="minmax", normalize_coords=False),
}


@pytest.mark.parametrize("name", sorted(ANCHOR_CASES))
def test_anchor_boxes_equal_jax(name):
    kw = ANCHOR_CASES[name]
    fh, fw = 7, 9
    jax_layer = JaxAnchorBoxes(**kw)
    fmap = np.zeros((2, fh, fw, 16), np.float32)
    expected = np.asarray(jax_layer.apply(jax_layer.init(jax.random.PRNGKey(0), fmap), fmap))
    layer = AnchorBoxes(**kw)
    got = layer(torch.zeros(2, 16, fh, fw))  # NCHW, as the port's feature maps
    assert got.dtype == torch.float32 and tuple(got.shape) == expected.shape
    np.testing.assert_array_equal(got.numpy(), expected)
    assert layer(torch.zeros(1, 3, fh, fw)).shape[0] == 1


@pytest.mark.parametrize("conversion", ["minmax2centroids", "centroids2minmax"])
def test_convert_coordinates2_equals_jax(conversion):
    t = np.random.RandomState(5).rand(6, 9) * 100
    expected = jax_boxes.convert_coordinates2(t, 3, conversion)
    np.testing.assert_allclose(boxes.convert_coordinates2(t, 3, conversion), expected, rtol=1e-12)
    got = boxes.convert_coordinates2(torch.from_numpy(t), -6, conversion)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-12)
    with pytest.raises(ValueError, match="Supported conversions"):
        boxes.convert_coordinates2(t, 0, "corners2centroids")


def test_draw_detections_equals_jax():
    img = np.random.RandomState(1).randint(0, 256, (64, 80, 3), dtype=np.uint8)
    dets = np.array([[1, 0.9, 5, 20, 40, 60], [2, 0.7, 30, 2, 78, 30],
                     [0, 0.0, 0, 0, 0, 0], [3, 0.2, 10, 10, 20, 20]])
    for names in (["bg", "car", "person", "dog"], None):
        got = draw_detections(img, dets, class_names=names)
        expected = jax_draw_detections(img, dets, class_names=names)
        assert got.shape == (64, 80, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, expected)
        assert not np.array_equal(got, img)
    gray = img[..., 0]
    np.testing.assert_array_equal(draw_detections(gray, dets), jax_draw_detections(gray, dets))
