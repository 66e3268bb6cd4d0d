"""BatchNorm and preprocessing folding (ssd_keras_torch/optimize.py).

The nine cases of ``tests/test_optimize.py`` on the port (a folded SSD7
equals the unfolded one; errors for nothing to fold, an unmatched BN and a
bad swap), and the folded parameters against the JAX package's
``fold_batchnorm`` / ``fold_preprocessing`` of the same variables, carried
across by ``weights_io.to_flax_params``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.optimize import fold_batchnorm as jax_fold_batchnorm
from ssd_keras_tpu.optimize import fold_preprocessing as jax_fold_preprocessing
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.models import ssd_7, ssd_300
from ssd_keras_torch.optimize import fold_batchnorm, fold_preprocessing
from ssd_keras_torch.weights_io import from_flax_params, to_flax_params

torch.set_num_threads(2)


def _nontrivial_stats(model, seed=0):
    """Replace init's (mean=0, var=1, gamma=1, beta=0) with random values so
    the fold has to do real work to match (tests/test_optimize.py's draws)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for i in range(1, 8):
            bn = getattr(model, f"bn{i}")
            c = bn.running_mean.shape[0]
            bn.running_mean.copy_(torch.from_numpy(rng.randn(c).astype(np.float32) * 0.5))
            bn.running_var.copy_(torch.from_numpy(rng.rand(c).astype(np.float32) * 2 + 0.1))
            bn.weight.copy_(torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5))
            bn.bias.copy_(torch.from_numpy(rng.randn(c).astype(np.float32) * 0.2))
    return model


@pytest.fixture(scope="module")
def ssd7_pair():
    cfg = SSDConfig.ssd7(img_height=64, img_width=64)
    model, _ = ssd_7(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model = _nontrivial_stats(model)
    folded_model, _ = ssd_7(cfg, fold_bn=True, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32) * 255)
    return model, folded_model, x


def test_folded_matches_unfolded(ssd7_pair):
    """Within 1e-4 (tests/test_optimize.py allows 2e-4): the BN scale is
    rounded into each f32 kernel weight before the sums instead of applied
    after them, which moves y_pred by ~2e-5 through seven layers."""
    model, folded_model, x = ssd7_pair
    folded_model.load_state_dict(fold_batchnorm(model.state_dict()))
    with torch.no_grad():
        y_ref, y_fold = model(x), folded_model(x)
    np.testing.assert_allclose(y_fold.numpy(), y_ref.numpy(), rtol=1e-4, atol=1e-4)


def test_folded_params_have_no_bn(ssd7_pair):
    model, folded_model, _ = ssd7_pair
    folded = fold_batchnorm(model.state_dict())
    assert not any(k.startswith("bn") for k in folded)
    for i in range(1, 8):
        assert {k for k in folded if k.startswith(f"conv{i}.")} == {f"conv{i}.weight",
                                                                   f"conv{i}.bias"}
    assert set(folded) == set(folded_model.state_dict())
    params, stats = to_flax_params(folded)
    assert stats == {} and not any(k.startswith("bn") for k in params)


def test_fold_bn_refuses_training(ssd7_pair):
    _, folded_model, _ = ssd7_pair
    with pytest.raises(ValueError, match="inference-only"):
        folded_model.train()
    assert not folded_model.training


def test_fold_requires_batch_stats():
    with pytest.raises(ValueError, match="batch_stats"):
        fold_batchnorm({"conv1.weight": torch.zeros(4, 3, 3, 3)})


def test_fold_rejects_unmatched_bn():
    state = {"convA.weight": torch.zeros(4, 3, 3, 3), "convA.bias": torch.zeros(4),
             "bnB.weight": torch.ones(4), "bnB.bias": torch.zeros(4),
             "bnB.running_mean": torch.zeros(4), "bnB.running_var": torch.ones(4)}
    with pytest.raises(ValueError, match="no matching conv"):
        fold_batchnorm(state)


def test_explicit_pairs():
    rng = np.random.RandomState(3)
    k = rng.randn(4, 2, 3, 3).astype(np.float32)  # OIHW
    b = rng.randn(4).astype(np.float32)
    gamma = rng.rand(4).astype(np.float32) + 0.5
    beta = rng.randn(4).astype(np.float32)
    mean = rng.randn(4).astype(np.float32)
    var = rng.rand(4).astype(np.float32) + 0.1
    eps = 1e-3
    t = torch.from_numpy
    state = {"c.weight": t(k), "c.bias": t(b), "n.weight": t(gamma), "n.bias": t(beta),
             "n.running_mean": t(mean), "n.running_var": t(var)}
    folded = fold_batchnorm(state, pairs=[("c", "n")], epsilon=eps)
    assert set(folded) == {"c.weight", "c.bias"}
    x = t(rng.randn(1, 2, 8, 8).astype(np.float32))
    y_ref = F.conv2d(x, t(k), t(b), padding=1).permute(0, 2, 3, 1).numpy()
    y_ref = (y_ref - mean) / np.sqrt(var + eps) * gamma + beta
    y_fold = F.conv2d(x, folded["c.weight"], folded["c.bias"], padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y_fold.numpy(), y_ref, rtol=1e-5, atol=1e-5)


def test_fold_preprocessing_exact():
    """Channel swap + stddev division folded into conv1's kernel give the
    same outputs as the in-graph preprocessing, the image border included."""
    cfg = dataclasses.replace(SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64),
                              swap_channels=(2, 0, 1))
    assert cfg.subtract_mean and cfg.divide_by_stddev and cfg.swap_channels
    model, _ = ssd_7(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32) * 255)
    state2, cfg2 = fold_preprocessing(model.state_dict(), cfg, conv_name="conv1")
    assert cfg2.swap_channels is None and cfg2.divide_by_stddev is None
    assert cfg2.subtract_mean == cfg.subtract_mean
    model2, _ = ssd_7(cfg2, device="cpu")
    model2.load_state_dict(state2)
    with torch.no_grad():
        np.testing.assert_allclose(model2(x).numpy(), model(x).numpy(), rtol=1e-5, atol=1e-5)


def test_fold_preprocessing_requires_something_to_fold():
    cfg = dataclasses.replace(SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64),
                              divide_by_stddev=None, swap_channels=None)
    model, _ = ssd_7(cfg, device="cpu")
    with pytest.raises(ValueError, match="nothing to fold"):
        fold_preprocessing(model.state_dict(), cfg, conv_name="conv1")


def test_fold_preprocessing_rejects_bad_swap():
    cfg = SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64)
    model, _ = ssd_7(cfg, device="cpu")
    bad = dataclasses.replace(cfg, swap_channels=(0, 0, 1))
    with pytest.raises(ValueError, match="not a permutation"):
        fold_preprocessing(model.state_dict(), bad, conv_name="conv1")


def _jax_variables(state_dict):
    params, stats = to_flax_params(state_dict)
    to_jax = lambda tree: {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in tree.items()}
    return {"params": to_jax(params), "batch_stats": to_jax(stats)}


def _assert_state_equal(got, expected_params, tol):
    expected = from_flax_params({k: {n: np.asarray(v) for n, v in d.items()}
                                 for k, d in expected_params.items()})
    assert set(got) == set(expected)
    for key, value in expected.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=0, atol=tol,
                                   err_msg=key)


def test_fold_batchnorm_equals_jax(ssd7_pair):
    """The same variables folded by both packages, within 1e-7: both fold in
    float64 and round once to f32."""
    model, _, _ = ssd7_pair
    state = model.state_dict()
    _assert_state_equal(fold_batchnorm(state), jax_fold_batchnorm(_jax_variables(state))["params"],
                        1e-7)


@pytest.mark.parametrize("arch", ["ssd7", "ssd300"])
def test_fold_preprocessing_equals_jax(arch):
    if arch == "ssd7":
        cfg = dataclasses.replace(SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64),
                                  swap_channels=(2, 0, 1))
        jax_cfg = dataclasses.replace(JaxSSDConfig.ssd7(n_classes=3, img_height=64, img_width=64),
                                      swap_channels=(2, 0, 1))
        model, _ = ssd_7(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
        conv = "conv1"
    else:
        cfg, jax_cfg = SSDConfig.ssd300(), JaxSSDConfig.ssd300()
        model, _ = ssd_300(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
        conv = "conv1_1"
    state = model.state_dict()
    got, got_cfg = fold_preprocessing(state, cfg, conv_name=conv)
    variables = _jax_variables(state)
    expected, expected_cfg = jax_fold_preprocessing(variables, jax_cfg, conv_name=conv)
    assert (got_cfg.swap_channels, got_cfg.divide_by_stddev, got_cfg.subtract_mean) == (
        expected_cfg.swap_channels, expected_cfg.divide_by_stddev, expected_cfg.subtract_mean)
    _assert_state_equal({k: v for k, v in got.items() if "running" not in k},
                        expected["params"], 1e-7)


def test_ssd300_fold_preprocessing_keeps_y_pred():
    """SSD300's conv1_1 after the fold: y_pred within 1e-4 at f32 (the
    channel swap and 1/std reassociate conv1_1's sums)."""
    cfg = SSDConfig.ssd300()
    model, _ = ssd_300(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        model.conv1_1.weight.mul_(0.01)
    state2, cfg2 = fold_preprocessing(model.state_dict(), cfg)
    model2, _ = ssd_300(cfg2, device="cpu")
    model2.load_state_dict(state2)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 300, 300, 3).astype(np.float32) * 255)
    with torch.no_grad():
        np.testing.assert_allclose(model2(x).numpy(), model(x).numpy(), rtol=0, atol=1e-4)
