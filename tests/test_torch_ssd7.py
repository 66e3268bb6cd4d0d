"""The port's SSD7 and its flax-style BatchNorm against the JAX package.

Weights come from flax ``init`` (with random BatchNorm statistics, so the
running-statistics path is not the identity) and reach the port through
``weights_io.from_flax_params``. The JAX model runs with its plain conv1
(``s2d_trunk=False``), the form the port has; one case runs the JAX
default, its space-to-depth rewrite, which gives the same output up to
summation order.
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from ssd_keras_tpu import weights_io as jax_weights_io
from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.models import ssd_7 as jax_ssd_7
from ssd_keras_tpu.models import ssd7_predictor_sizes as jax_ssd7_sizes
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.models import BatchNorm, ssd_7, ssd7_predictor_sizes
from ssd_keras_torch.weights_io import from_flax_params, load_keras_h5_weights, to_flax_params

torch.set_num_threads(2)

# f32 y_pred tolerance: seven conv+BN+ELU blocks summed in other orders by
# XLA and PyTorch move y_pred by ~1e-6; a wrong layer errs by orders more.
Y_TOL = 1e-4


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def shared():
    """(config kwargs, flax params, flax batch_stats, images)."""
    kw = dict(n_classes=3, img_height=64, img_width=64)
    model, _ = jax_ssd_7(JaxSSDConfig.ssd7(**kw), s2d_trunk=False)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32) * 255
    variables = model.init(jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(1)
    stats = _numpy(variables["batch_stats"])
    for layer in stats.values():
        layer["mean"] = rng.randn(*layer["mean"].shape).astype(np.float32) * 0.1
        layer["var"] = rng.uniform(0.5, 2.0, layer["var"].shape).astype(np.float32)
    params = _numpy(variables["params"])
    for name, layer in params.items():
        if name.startswith("bn"):
            layer["scale"] = rng.uniform(0.5, 1.5, layer["scale"].shape).astype(np.float32)
            layer["bias"] = rng.randn(*layer["bias"].shape).astype(np.float32) * 0.1
    return kw, params, stats, x


def _port(kw, params, stats, **build):
    model, _ = ssd_7(SSDConfig.ssd7(**kw), **build, device="cpu")
    model.load_state_dict(from_flax_params(params, stats))
    return model


@pytest.mark.parametrize("hw", [(64, 64), (300, 480), (65, 99)])
def test_predictor_sizes_equal_jax(hw):
    assert ssd7_predictor_sizes(*hw) == jax_ssd7_sizes(*hw)


@pytest.mark.parametrize("s2d_trunk", [False, True])
def test_eval_y_pred_matches_flax(shared, s2d_trunk):
    kw, params, stats, x = shared
    flax_model, _ = jax_ssd_7(JaxSSDConfig.ssd7(**kw), s2d_trunk=s2d_trunk)
    expected = np.asarray(flax_model.apply({"params": params, "batch_stats": stats}, x))
    with torch.no_grad():
        got = _port(kw, params, stats)(torch.from_numpy(x)).numpy()
    assert got.shape == expected.shape == (2, 340, 16)
    np.testing.assert_allclose(got, expected, rtol=Y_TOL, atol=Y_TOL)


def test_train_mode_y_pred_and_statistics_match_flax(shared):
    """Batch statistics in the forward, and the running statistics after it:
    flax moves the running variance with the *biased* batch variance."""
    kw, params, stats, x = shared
    flax_model, _ = jax_ssd_7(JaxSSDConfig.ssd7(**kw), s2d_trunk=False)
    expected, mutated = flax_model.apply({"params": params, "batch_stats": stats}, x,
                                         train=True, mutable=["batch_stats"])
    model = _port(kw, params, stats).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(expected), rtol=Y_TOL, atol=Y_TOL)
    _, got_stats = to_flax_params(model.state_dict())
    for layer, tensors in _numpy(mutated["batch_stats"]).items():
        for key, value in tensors.items():
            np.testing.assert_allclose(got_stats[layer][key], value, rtol=1e-5, atol=1e-6)
            assert not np.allclose(value, stats[layer][key])  # they moved


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_flax_and_differs_from_torch(train):
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 5, 6, 8) * 3 + 1).astype(np.float32)  # NHWC
    flax_bn = fnn.BatchNorm(use_running_average=not train, momentum=0.99, epsilon=1e-3)
    variables = {"params": {"scale": rng.rand(8).astype(np.float32) + 0.5,
                            "bias": rng.randn(8).astype(np.float32)},
                 "batch_stats": {"mean": rng.randn(8).astype(np.float32),
                                 "var": rng.rand(8).astype(np.float32) + 0.5}}
    expected, mutated = flax_bn.apply(variables, x, mutable=["batch_stats"])
    bn = BatchNorm(8).train(train)
    state = from_flax_params({"bn": variables["params"]}, {"bn": variables["batch_stats"]})
    bn.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    with torch.no_grad():
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(expected), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), mutated["batch_stats"]["var"], rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), mutated["batch_stats"]["mean"],
                               rtol=1e-6, atol=1e-7)
    if train:  # nn.BatchNorm2d would move the variance with the unbiased value
        torch_bn = torch.nn.BatchNorm2d(8, eps=1e-3, momentum=0.01)
        torch_bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
        torch_bn(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert not np.allclose(torch_bn.running_var.detach().numpy(), bn.running_var.numpy(),
                               rtol=1e-6)


def test_bf16_compute_keeps_f32_statistics(shared):
    kw, params, stats, x = shared
    model = _port(kw, params, stats, compute_dtype=torch.bfloat16).train()
    with torch.no_grad():
        y = model(torch.from_numpy(x))
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    assert all(t.dtype == torch.float32 for t in model.state_dict().values())


def test_flax_conversion_round_trips_with_batch_stats(shared):
    kw, params, stats, _ = shared
    state = from_flax_params(params, stats)
    model, _ = ssd_7(SSDConfig.ssd7(**kw), device="cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)  # strict: every key and shape matches
    assert state["bn3.weight"].shape == state["bn3.running_var"].shape == (64,)
    back_params, back_stats = to_flax_params(model.state_dict())
    for tree, back in ((params, back_params), (stats, back_stats)):
        assert set(back) == set(tree)
        for layer, tensors in tree.items():
            assert set(back[layer]) == set(tensors)
            for key, value in tensors.items():
                np.testing.assert_array_equal(back[layer][key], value)


def test_h5_with_batchnorm_written_by_jax_loads_into_port(shared, tmp_path):
    """``save_keras_h5_weights`` (JAX, with batch_stats) -> the port's
    ``load_keras_h5_weights``: all 22 layers load, and y_pred equals the
    ``from_flax_params`` model's bit for bit."""
    kw, params, stats, x = shared
    path = str(tmp_path / "ssd7.h5")
    jax_weights_io.save_keras_h5_weights(path, params, stats)
    model, _ = ssd_7(SSDConfig.ssd7(**kw), generator=torch.Generator().manual_seed(3), device="cpu")
    loaded = load_keras_h5_weights(path, model, on_unconsumed="raise")
    assert sorted(loaded) == sorted(params) and len(loaded) == 22
    with torch.no_grad():
        a = model(torch.from_numpy(x))
        b = _port(kw, params, stats)(torch.from_numpy(x))
    assert torch.equal(a, b)
