"""The port's vendored SynthVOC renders what the JAX package's does."""

import numpy as np
import pytest

from ssd_keras_tpu.data.synthvoc import SynthVOC as JaxSynthVOC
from ssd_keras_torch.data import SYNTHVOC_CLASS_NAMES, SynthVOC


@pytest.mark.parametrize("split, index, size, seed",
                         [("train", 0, 300, 0), ("train", 17, 300, 0), ("val", 3, 300, 0),
                          ("test", 5, 128, 2), ("train", 9, 512, 1)])
def test_render_equals_jax(split, index, size, seed):
    image, labels = SynthVOC(32, image_size=size, split=split, seed=seed).render(index)
    exp_image, exp_labels = JaxSynthVOC(32, image_size=size, split=split, seed=seed).render(index)
    assert image.dtype == np.uint8 and image.shape == (size, size, 3)
    np.testing.assert_array_equal(image, exp_image)
    np.testing.assert_array_equal(labels, exp_labels)


def test_materialize_equals_jax():
    images, labels = SynthVOC(3, image_size=96, split="val").materialize()
    exp_images, exp_labels = JaxSynthVOC(3, image_size=96, split="val").materialize()
    np.testing.assert_array_equal(images, exp_images)
    for got, exp in zip(labels, exp_labels):
        np.testing.assert_array_equal(got, exp)
    assert len(SYNTHVOC_CLASS_NAMES) == 21 and SYNTHVOC_CLASS_NAMES[0] == "background"
