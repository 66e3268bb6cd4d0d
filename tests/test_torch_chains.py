"""The port's four augmentation chains and the host training slice against
the JAX package's, which run OpenCV.

Each chain runs on 8 SynthVOC images at 300x300 with their labels, under the
same ``np.random`` and ``random`` seeds on both sides. Labels must be equal
bit for bit: they depend on the draws and on integer box arithmetic only, so
one extra or misplaced draw would break them. Pixels: the colour
conversions, linear, area and Lanczos resizes and the integer translation
are exact, and the one transform that is not (``INTER_CUBIC``, summed in
float32 in another order than OpenCV's vector code, about one pixel in ten
thousand off by one level) feeds nothing that amplifies it: it is the last
step of the chains that draw it. Measured over these images: the largest
|difference| is 1 and at least 99.99% of pixels are equal. The gate is
within one level and at least 99.9% equal on every image.

The slice: ``DataGenerator.generate`` with ``SSDDataAugmentation(300, 300)``
and each side's encoder over a SynthVOC split at batch 4 (the port's
encoder on the CPU), then one SGD train step of a small SSD7 (n_classes 20
at 300x300) from the same weights, carried across by ``weights_io``.
``encoded_labels`` within 1e-5; images within the chain tolerance; the loss
within the 1e-5 relative of tests/test_torch_train_slice.py.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_keras_tpu import train as jax_train
from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.data import chains as J
from ssd_keras_tpu.data.datasets import DataGenerator as JaxDataGenerator
from ssd_keras_tpu.encoder import SSDInputEncoder as JaxSSDInputEncoder
from ssd_keras_tpu.loss import SSDLoss as JaxSSDLoss
from ssd_keras_tpu.models import ssd_7 as jax_ssd_7
from ssd_keras_torch import SSDConfig, SSDInputEncoder, SSDLoss, from_flax_params, ssd_7
from ssd_keras_torch import train as T
from ssd_keras_torch.data import SynthVOC
from ssd_keras_torch.data import chains as P
from ssd_keras_torch.data.datasets import DataGenerator

torch.set_num_threads(2)

MAX_DIFF = 1
MIN_EQUAL = 0.999
ENCODED_TOL = 1e-5
LOSS_RTOL = 1e-5

CHAINS = {
    "SSDDataAugmentation": lambda m: m.SSDDataAugmentation(300, 300),
    "DataAugmentationConstantInputSize": lambda m: m.DataAugmentationConstantInputSize(),
    "DataAugmentationVariableInputSize": lambda m: m.DataAugmentationVariableInputSize(300, 300),
    "DataAugmentationSatellite": lambda m: m.DataAugmentationSatellite(300, 300),
}


@pytest.fixture(scope="module")
def split():
    images, labels = SynthVOC(8, image_size=300, split="train", seed=5).materialize()
    return images, [l.astype(np.float64) for l in labels]


def _assert_chain_pixels(got, expected):
    assert got.shape == expected.shape and got.dtype == expected.dtype == np.uint8
    diff = np.abs(got.astype(int) - expected.astype(int))
    assert diff.max() <= MAX_DIFF, diff.max()
    assert (diff == 0).mean() >= MIN_EQUAL, (diff == 0).mean()


def _seeded(seed, fn):
    """``fn()`` from seeded ``np.random`` and ``random``, and the states of
    both after it."""
    np.random.seed(seed)
    random.seed(seed)
    return fn(), (np.random.get_state()[1].copy(), random.getstate())


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_equals_jax(name, split):
    images, labels = split
    jax_chain, port_chain = CHAINS[name](J), CHAINS[name](P)
    for i in range(len(images)):
        exp, exp_state = _seeded(100 + i, lambda: jax_chain(images[i].copy(), labels[i].copy()))
        got, got_state = _seeded(100 + i, lambda: port_chain(images[i].copy(), labels[i].copy()))
        np.testing.assert_array_equal(got[1], exp[1], err_msg=f"{name} image {i}")
        _assert_chain_pixels(got[0], exp[0])
        np.testing.assert_array_equal(got_state[0], exp_state[0])
        assert got_state[1] == exp_state[1]


@pytest.mark.parametrize("name", ["SSDDataAugmentation", "DataAugmentationVariableInputSize"])
def test_chain_inverters_map_boxes_alike(name, split):
    images, labels = split
    jax_chain, port_chain = CHAINS[name](J), CHAINS[name](P)
    for i in range(4):
        exp, _ = _seeded(7 + i, lambda: jax_chain(images[i].copy(), labels[i].copy(),
                                                  return_inverter=True))
        got, _ = _seeded(7 + i, lambda: port_chain(images[i].copy(), labels[i].copy(),
                                                   return_inverter=True))
        np.testing.assert_array_equal(got[1], exp[1])
        assert len(got[2]) == len(exp[2]) > 0
        preds = np.concatenate([np.ones((len(got[1]), 1)), np.full((len(got[1]), 1), 0.9),
                                got[1][:, 1:] + 0.25], axis=1)
        for g, e in zip(got[2], exp[2]):
            preds_g, preds_e = g(preds), e(preds)
            np.testing.assert_array_equal(preds_g, preds_e)
            preds = preds_g


def _generator(module, images, labels):
    gen = module()
    gen.images = [images[i] for i in range(len(images))]
    gen.labels = [np.asarray(l) for l in labels]
    gen.image_ids = list(range(len(images)))
    gen.dataset_size = len(images)
    gen.dataset_indices = np.arange(len(images), dtype=np.int32)
    return gen


SSD7 = dict(n_classes=20, img_height=300, img_width=300)


def test_host_chain_training_slice_equals_jax(split):
    images, labels = split
    jax_model, sizes = jax_ssd_7(JaxSSDConfig.ssd7(**SSD7), s2d_trunk=False)
    batches = {}
    for side in ("jax", "port"):
        if side == "jax":
            gen = _generator(JaxDataGenerator, images, labels)
            aug, enc = J.SSDDataAugmentation(300, 300), JaxSSDInputEncoder(
                JaxSSDConfig.ssd7(**SSD7), sizes, max_gt_boxes=16)
        else:
            gen = _generator(DataGenerator, images, labels)
            aug, enc = P.SSDDataAugmentation(300, 300), SSDInputEncoder(
                SSDConfig.ssd7(**SSD7), sizes, max_gt_boxes=16, device="cpu")
        it = gen.generate(batch_size=4, shuffle=True, transformations=[aug], label_encoder=enc,
                          returns=["processed_images", "encoded_labels", "processed_labels"])
        batches[side], _ = _seeded(21, lambda: [next(it) for _ in range(2)])
    for (gx, gy, gl), (ex, ey, el) in zip(batches["port"], batches["jax"]):
        assert len(gl) == len(el)
        for a, b in zip(gl, el):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(gx, ex):
            _assert_chain_pixels(a, b)
        assert gy.shape == np.asarray(ey).shape
        np.testing.assert_allclose(gy, np.asarray(ey), rtol=0, atol=ENCODED_TOL)

    x_jax, y_jax, _ = batches["jax"][0]
    x_port, y_port, _ = batches["port"][0]
    tx = jax_train.sgd_with_momentum(1e-3, 0.9, clipnorm=5.0)
    state = jax_train.create_train_state(jax_model, jax.random.PRNGKey(0),
                                         np.asarray(x_jax, np.float32), tx)
    model, _ = ssd_7(SSDConfig.ssd7(**SSD7), device="cpu")
    model.load_state_dict(from_flax_params(jax.tree_util.tree_map(np.asarray, dict(state.params)),
                                           jax.tree_util.tree_map(np.asarray,
                                                                  dict(state.batch_stats))))
    jax_step = jax_train.make_train_step(jax_model, JaxSSDLoss(), l2_reg=5e-4, donate=False)
    _, expected = jax_step(state, jnp.asarray(x_jax, jnp.float32), jnp.asarray(y_jax))
    opt = T.sgd_with_momentum(model.parameters(), 1e-3, 0.9, clipnorm=5.0)
    got = T.make_train_step(model, opt, SSDLoss(), l2_reg=5e-4)(
        torch.from_numpy(np.asarray(x_port, np.float32)), torch.from_numpy(y_port))
    assert np.isfinite(float(got["loss"]))
    np.testing.assert_allclose(float(got["loss"]), float(expected["loss"]), rtol=LOSS_RTOL)
