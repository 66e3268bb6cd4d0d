"""The overfit smoke's training recipe over several steps: the port against
the JAX package on the same batches.

``examples/synthetic_smoke_ssd300.py`` (JAX) and its port train a 3-class
SSD300 from its raw He init with SGD momentum 0.9, lr 1e-4, clipnorm 5 and
L2 5e-4. Here both take the same weights (the JAX smoke's
``create_train_state`` params, through ``from_flax_params``) and the same
batches: the JAX script's own dataset, augmentation keys and encoder, at
batch 2, f32 on the CPU. Four steps exercise what the one-step slice test
(tests/test_torch_train_slice.py) cannot: the momentum carried between
steps and the clip of each step's gradient, from the init the smoke uses.
The loss must agree within 1e-3 relative at every step, and every
parameter within 1e-2 of the largest total update after the last: the two
libraries' gradients differ by summation order (~1e-5 relative), which
momentum and four updates carry forward. (At this init some layers get no
update in four steps on either side, conv9 and fc7's class head among
them, and the L2Normalization gamma's updates stay under an ulp of 20.)
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ssd_keras_tpu import train as jax_train
from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.data.device_aug import DeviceSSDAugmentation as JaxAugmentation
from ssd_keras_tpu.encoder import SSDInputEncoder as JaxEncoder
from ssd_keras_tpu.encoder import pad_labels
from ssd_keras_tpu.loss import SSDLoss as JaxSSDLoss
from ssd_keras_tpu.models import ssd_300 as jax_ssd_300
from ssd_keras_torch import SSDConfig, SSDLoss, from_flax_params, ssd_300
from ssd_keras_torch import train as T
from ssd_keras_torch.examples import synthetic_smoke_ssd300
from ssd_keras_torch.weights_io import to_flax_params

torch.set_num_threads(2)

STEPS = 4
BATCH = 2
LOSS_RTOL = 1e-3
PARAM_TOL = 1e-2
EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _jax_smoke_module():
    spec = importlib.util.spec_from_file_location(
        "jax_smoke_example", EXAMPLES / "synthetic_smoke_ssd300.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_recipe_tracks_jax_over_steps():
    images, labels = _jax_smoke_module().make_dataset(16, np.random.RandomState(0))
    port_images, port_labels = synthetic_smoke_ssd300.make_dataset(16, np.random.RandomState(0))
    np.testing.assert_array_equal(port_images, images)
    for a, b in zip(port_labels, labels):
        np.testing.assert_array_equal(a, b)

    # The JAX smoke's model, init, optimizer and step, in f32.
    config = JaxSSDConfig.ssd300(n_classes=3)
    jax_model, sizes = jax_ssd_300(config)
    encoder = JaxEncoder(config, sizes, max_gt_boxes=16)
    aug = JaxAugmentation(300, 300)
    tx = jax_train.sgd_with_momentum(learning_rate=1e-4, momentum=0.9, clipnorm=5.0)
    state = jax_train.create_train_state(jax_model, jax.random.PRNGKey(0),
                                         images[:BATCH].astype(np.float32), tx)
    jax_step = jax_train.make_train_step(jax_model, JaxSSDLoss(), l2_reg=5e-4, donate=False)
    start = jax.tree_util.tree_map(np.asarray, dict(state.params))

    model, _ = ssd_300(SSDConfig.ssd300(n_classes=3), device="cpu")
    model.load_state_dict(from_flax_params(start))
    opt = T.sgd_with_momentum(model.parameters(), 1e-4, momentum=0.9, clipnorm=5.0)
    port_step = T.make_train_step(model, opt, SSDLoss(), l2_reg=5e-4)

    padded, counts = pad_labels(labels, encoder.max_gt_boxes)
    key = jax.random.PRNGKey(1)
    for step in range(STEPS):  # the JAX script's keys and draws
        key, k1, k2 = jax.random.split(key, 3)
        idx = jax.random.choice(k1, len(images), (BATCH,), replace=True)
        imgs, lbls, nn = aug(k2, jnp.asarray(images)[idx], jnp.asarray(padded)[idx],
                             jnp.asarray(counts)[idx])
        y_true = encoder.encode_padded(lbls, nn)
        state, expected = jax_step(state, imgs, y_true)
        got = port_step(torch.tensor(np.asarray(imgs)), torch.tensor(np.asarray(y_true)))
        for name in ("loss", "data_loss"):
            np.testing.assert_allclose(float(got[name]), float(expected[name]), rtol=LOSS_RTOL,
                                       err_msg=f"step {step} {name}")

    after = jax.tree_util.tree_map(np.asarray, dict(state.params))
    update = max(np.abs(after[l][k] - start[l][k]).max() for l in after for k in after[l])
    assert update > 0
    got_params, _ = to_flax_params(model.state_dict())
    for layer, tensors in after.items():
        for name, value in tensors.items():
            np.testing.assert_allclose(got_params[layer][name], value, rtol=0,
                                       atol=PARAM_TOL * update, err_msg=f"{layer}/{name}")
