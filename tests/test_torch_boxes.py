"""The port's torch box ops against the JAX package's ``ops/boxes.py``.

Boxes are jittered (non-integer) from a seed. ``iou`` and
``intersection_area`` run through ``jax.numpy`` on the CPU on the JAX side;
values agree within 1e-6 relative (f32 arithmetic in one order on both
sides; XLA may contract a multiply-add, which moves the last bit).
``convert_coordinates`` on a tensor must equal its NumPy path bit for bit:
one set of formulas serves both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_keras_tpu.ops import boxes as jax_boxes
from ssd_keras_torch.ops import boxes

RTOL = 1e-6


def _boxes(seed, n, coords):
    """(n, 4) boxes in ``coords`` format inside a 300x300 frame."""
    rng = np.random.RandomState(seed)
    wh = rng.uniform(5, 150, (n, 2))
    xy = rng.uniform(0, 1, (n, 2)) * (300 - wh)
    corners = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    if coords == "corners":
        return corners
    if coords == "minmax":
        return corners[:, [0, 2, 1, 3]]
    return np.concatenate([xy + wh / 2, wh], axis=1).astype(np.float32)


@pytest.mark.parametrize("fn", ["iou", "intersection_area"])
@pytest.mark.parametrize("coords", ["corners", "minmax", "centroids"])
@pytest.mark.parametrize("border_pixels", ["half", "include", "exclude"])
def test_outer_product_equals_jax(fn, coords, border_pixels):
    a, b = _boxes(0, 7, coords), _boxes(1, 300, coords)
    expected = np.asarray(getattr(jax_boxes, fn)(
        jnp.asarray(a), jnp.asarray(b), coords=coords, mode="outer_product",
        border_pixels=border_pixels, xp=jnp))
    got = getattr(boxes, fn)(torch.from_numpy(a), torch.from_numpy(b), coords=coords,
                             mode="outer_product", border_pixels=border_pixels).numpy()
    assert got.shape == expected.shape == (7, 300)
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=1e-6)
    if fn == "iou":
        assert (got > 0).any() and (got == 0).any()


@pytest.mark.parametrize("coords", ["corners", "centroids"])
def test_element_wise_and_batched_equal_jax(coords):
    a, b = _boxes(2, 12, coords), _boxes(3, 12, coords)
    expected = np.asarray(jax_boxes.iou(jnp.asarray(a), jnp.asarray(b), coords=coords,
                                        mode="element-wise", xp=jnp))
    got = boxes.iou(torch.from_numpy(a), torch.from_numpy(b), coords=coords, mode="element-wise")
    np.testing.assert_allclose(got.numpy(), expected, rtol=RTOL, atol=1e-7)
    # A leading batch axis, as the encoder uses: (B, m, 4) against (n, 4).
    batched = boxes.iou(torch.from_numpy(a.reshape(3, 4, 4)), torch.from_numpy(b), coords=coords)
    per_image = [boxes.iou(torch.from_numpy(x), torch.from_numpy(b), coords=coords)
                 for x in a.reshape(3, 4, 4)]
    assert torch.equal(batched, torch.stack(per_image))


@pytest.mark.parametrize("conversion", ["minmax2centroids", "centroids2minmax", "corners2centroids",
                                        "centroids2corners", "minmax2corners", "corners2minmax"])
@pytest.mark.parametrize("border_pixels", ["half", "include"])
def test_convert_coordinates_tensor_equals_numpy(conversion, border_pixels):
    x = np.random.RandomState(4).uniform(0, 300, (2, 5, 7)).astype(np.float32)
    expected = boxes.convert_coordinates(x, 2, conversion, border_pixels)
    got = boxes.convert_coordinates(torch.from_numpy(x), 2, conversion, border_pixels)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(
        expected, jax_boxes.convert_coordinates(x, 2, conversion, border_pixels))


def test_bad_arguments_raise():
    a = torch.from_numpy(_boxes(5, 3, "corners"))
    with pytest.raises(ValueError, match="coords"):
        boxes.iou(a, a, coords="xywh")
    with pytest.raises(ValueError, match="mode"):
        boxes.intersection_area(a, a, mode="pairwise")
    with pytest.raises(ValueError, match="border_pixels"):
        boxes.iou(a, a, coords="corners", border_pixels="none")
