"""The whole training slice at full width: one SSD300 train step, the port
against the JAX package.

SynthVOC image 0 at 300x300 (batch 1), its labels encoded by the port's
encoder (equal to the JAX encoder's: tests/test_torch_encoder.py); flax
``init`` weights with conv1_1 scaled by 1/100 on both sides (see
tests/test_torch_models.py); SGD with momentum 0.9, L2 5e-4 and clipnorm 5,
at f32 on the CPU. The loss must agree within 1e-5 relative, and every
parameter after the step within 1e-3 of the step's largest update: the
gradients of the two libraries differ by summation order only (SSD300 has
no BatchNorm), ~1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ssd_keras_tpu import train as jax_train
from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.loss import SSDLoss as JaxSSDLoss
from ssd_keras_tpu.models import ssd_300 as jax_ssd_300
from ssd_keras_torch import SSDConfig, SSDInputEncoder, SSDLoss, from_flax_params, ssd_300
from ssd_keras_torch import train as T
from ssd_keras_torch.data import SynthVOC
from ssd_keras_torch.weights_io import to_flax_params

torch.set_num_threads(2)

LR = 1e-3
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-3


def test_ssd300_train_step_equals_jax():
    image, labels = SynthVOC(1, image_size=300, seed=0).render(0)
    x = image[None].astype(np.float32)
    jax_model, sizes = jax_ssd_300(JaxSSDConfig.ssd300(n_classes=20))
    y = SSDInputEncoder(SSDConfig.ssd300(n_classes=20), sizes, max_gt_boxes=8,
                        device="cpu")([labels])
    assert y.shape == (1, 8732, 33) and y[..., 1:21].sum() >= len(labels)

    tx = jax_train.sgd_with_momentum(LR, 0.9, clipnorm=5.0)
    state = jax_train.create_train_state(jax_model, jax.random.PRNGKey(0), x, tx)
    params = jax.tree_util.tree_map(np.asarray, dict(state.params))
    params["conv1_1"]["kernel"] = params["conv1_1"]["kernel"] / 100.0
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    jax_step = jax_train.make_train_step(jax_model, JaxSSDLoss(), l2_reg=5e-4, donate=False)
    state, expected = jax_step(state, jnp.asarray(x), jnp.asarray(y))

    model, _ = ssd_300(SSDConfig.ssd300(n_classes=20), device="cpu")
    model.load_state_dict(from_flax_params(params))
    opt = T.sgd_with_momentum(model.parameters(), LR, 0.9, clipnorm=5.0)
    got = T.make_train_step(model, opt, SSDLoss(), l2_reg=5e-4)(torch.from_numpy(x), torch.from_numpy(y))

    for key in ("loss", "data_loss"):
        np.testing.assert_allclose(float(got[key]), float(expected[key]), rtol=LOSS_RTOL)
    after = jax.tree_util.tree_map(np.asarray, dict(state.params))
    update = max(np.abs(after[l][k] - params[l][k]).max() for l in after for k in after[l])
    assert update > 0
    got_params, stats = to_flax_params(model.state_dict())
    assert stats == {}
    for layer, tensors in after.items():
        for key, value in tensors.items():
            np.testing.assert_allclose(got_params[layer][key], value, rtol=0,
                                       atol=PARAM_TOL * update, err_msg=f"{layer}/{key}")
