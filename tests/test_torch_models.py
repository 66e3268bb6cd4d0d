"""The port's SSD300 and its parts against the flax model, on shared weights.

Weights come from flax ``init`` and reach the port through
``weights_io.from_flax_params``; inputs are numpy arrays from a seed. The
whole-model check scales conv1_1 by 1/100 on both sides: He init carries the
raw 0-255 input's magnitude (~75 RMS) through the trunk, which saturates the
softmax to exactly 1.0 and overflows the box exponent; at 1/100 the scores
and offsets lie in a trained detector's range, so the comparison means
something.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.models import layers as jax_layers
from ssd_keras_tpu.models import ssd_300 as jax_ssd_300
from ssd_keras_tpu.models import ssd300_predictor_sizes as jax_sizes
from ssd_keras_tpu.models.common import assemble_predictions as jax_assemble
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.models import layers, ssd_7, ssd_300, ssd300_predictor_sizes
from ssd_keras_torch.models.common import assemble_predictions, validate_mode
from ssd_keras_torch.weights_io import from_flax_params, to_flax_params

torch.set_num_threads(2)


def _numpy_params(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables["params"]))


@pytest.fixture(scope="module")
def ssd300_shared():
    """(flax model, flax params as numpy with conv1_1 scaled, an image)."""
    cfg = JaxSSDConfig.ssd300(n_classes=20)
    model, _ = jax_ssd_300(cfg)
    x = np.random.RandomState(2).rand(1, 300, 300, 3).astype(np.float32) * 255
    params = _numpy_params(model.init(jax.random.PRNGKey(0), x))
    params["conv1_1"]["kernel"] = params["conv1_1"]["kernel"] / 100.0
    return model, params, x


@pytest.mark.parametrize("dataset, n_classes", [("voc", 20), ("coco", 80)])
def test_anchor_tensor_equals_jax(dataset, n_classes):
    sizes = ssd300_predictor_sizes(300, 300)
    got = SSDConfig.ssd300(n_classes=n_classes, dataset=dataset).anchor_tensor(sizes)
    expected = JaxSSDConfig.ssd300(n_classes=n_classes, dataset=dataset).anchor_tensor(sizes)
    assert got.shape == (8732, 8) and got.dtype == np.float64
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("hw", [(300, 300), (512, 512), (301, 300), (480, 640)])
def test_predictor_sizes_equal_jax(hw):
    assert ssd300_predictor_sizes(*hw) == jax_sizes(*hw)


def test_flax_conversion_round_trips(ssd300_shared):
    _, params, _ = ssd300_shared
    state = from_flax_params(params)
    model, _ = ssd_300(SSDConfig.ssd300(n_classes=20), device="cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)  # strict: every key and shape matches
    assert state["fc6.weight"].shape == (1024, 512, 3, 3)
    assert state["conv4_3_norm.gamma"].shape == (512,)
    back, stats = to_flax_params(model.state_dict())
    assert stats == {}  # SSD300 has no BatchNorm
    assert set(back) == set(params)
    for layer, tensors in params.items():
        assert set(back[layer]) == set(tensors)
        for key, value in tensors.items():
            np.testing.assert_array_equal(back[layer][key], value)


def test_ssd300_y_pred_matches_flax(ssd300_shared):
    """f32, batch 1, 300x300. Tolerance 1e-3: the two frameworks sum the
    convolutions in different orders, and through 20 VGG layers and the
    softmax that noise reaches ~1e-4 (the argument of
    tests/test_models.py:150-153); a wrong layer errs by orders more."""
    flax_model, params, x = ssd300_shared
    expected = np.asarray(flax_model.apply({"params": params}, x))
    model, _ = ssd_300(SSDConfig.ssd300(n_classes=20), device="cpu")
    model.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == expected.shape == (1, 8732, 33)
    assert 0.05 < expected[..., 1:21].max() < 0.999  # not saturated
    np.testing.assert_allclose(got, expected, rtol=1e-3, atol=1e-3)


def test_l2_normalization_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 7, 16).astype(np.float32) * 30
    x[0, 0, 0] = 0.0  # an all-zero pixel takes the 1e-12 clamp
    gamma = rng.rand(16).astype(np.float32) * 20
    expected = np.asarray(jax_layers.L2Normalization().apply({"params": {"gamma": gamma}}, x))
    mod = layers.L2Normalization(16)
    with torch.no_grad():
        mod.gamma.copy_(torch.from_numpy(gamma))
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("std, swap", [(None, (2, 1, 0)), ((127.5, 127.5, 127.5), None)])
def test_preprocess_input_matches_jax(std, swap):
    x = np.random.RandomState(1).rand(2, 4, 5, 3).astype(np.float32) * 255
    mean = (123.0, 117.0, 104.0)
    expected = np.asarray(jax_layers.preprocess_input(jnp.asarray(x), mean, std, swap))
    got = layers.preprocess_input(torch.from_numpy(x), mean, std, swap).numpy()
    np.testing.assert_array_equal(got, expected)


class _FlaxHead(fnn.Module):
    n_boxes: int
    n_classes: int

    @fnn.compact
    def __call__(self, feat):
        return jax_layers.fused_prediction_heads(
            self, feat, "fc7", self.n_boxes, self.n_classes, jnp.float32
        )


def test_fused_prediction_heads_match_flax():
    rng = np.random.RandomState(3)
    feat = rng.randn(2, 6, 5, 32).astype(np.float32)
    head = _FlaxHead(n_boxes=6, n_classes=5)
    params = _numpy_params(head.init(jax.random.PRNGKey(1), feat))
    for p in params.values():
        p["bias"] = rng.randn(*p["bias"].shape).astype(np.float32)
    exp_conf, exp_loc = head.apply({"params": params}, feat)
    state = from_flax_params(params)
    conf, loc = torch.nn.Conv2d(32, 30, 3, padding=1), torch.nn.Conv2d(32, 24, 3, padding=1)
    conf.load_state_dict({"weight": state["fc7_mbox_conf.weight"], "bias": state["fc7_mbox_conf.bias"]})
    loc.load_state_dict({"weight": state["fc7_mbox_loc.weight"], "bias": state["fc7_mbox_loc.bias"]})
    with torch.no_grad():
        weight, bias = layers.fuse_head_params(conf.weight, loc.weight, conf.bias, loc.bias,
                                               torch.float32)
        got_conf, got_loc = layers.fused_prediction_heads(
            torch.from_numpy(feat).permute(0, 3, 1, 2), weight, bias, conf.out_channels
        )
    np.testing.assert_allclose(got_conf.numpy(), exp_conf, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_loc.numpy(), exp_loc, rtol=1e-5, atol=1e-5)


def test_assemble_predictions_matches_jax():
    """The NHWC flatten order of the boxes and the f32 softmax."""
    rng = np.random.RandomState(4)
    shapes = [(3, 3, 4), (2, 2, 6)]
    conf = [rng.randn(2, h, w, n * 5).astype(np.float32) * 3 for h, w, n in shapes]
    loc = [rng.randn(2, h, w, n * 4).astype(np.float32) for h, w, n in shapes]
    anchors = rng.rand(sum(h * w * n for h, w, n in shapes), 8)
    expected = np.asarray(jax_assemble(conf, loc, anchors, 5))
    got = assemble_predictions(
        [torch.from_numpy(c) for c in conf], [torch.from_numpy(c) for c in loc],
        torch.from_numpy(anchors).float(), 5,
    ).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-7)


def test_pools_pad_at_the_end_like_same():
    """75 -> 38 with the last window holding only row/column 74."""
    x = np.random.RandomState(5).randn(1, 75, 75, 2).astype(np.float32)
    expected = np.asarray(fnn.max_pool(jnp.asarray(x), (2, 2), strides=(2, 2), padding="SAME"))
    got = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), expected)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        validate_mode("bogus")
    with pytest.raises(ValueError, match="mode"):
        ssd_300(mode="bogus", device="cpu")


def test_seeded_init_is_reproducible_across_builds():
    a, _ = ssd_300(generator=torch.Generator().manual_seed(7), device="cpu")
    b, _ = ssd_300(generator=torch.Generator().manual_seed(7), device="cpu")
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert torch.all(a.conv4_3_norm.gamma == 20.0)


def _ssd7_bf16(seed):
    model, _ = ssd_7(SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64),
                     compute_dtype=torch.bfloat16, generator=torch.Generator().manual_seed(seed),
                     device="cpu")
    return model


def _sgd_step(model, x):
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with torch.enable_grad():
        model(x)[..., :4].square().mean().backward()
    opt.step()


def _load_other(model, x):
    model.load_state_dict(_ssd7_bf16(seed=1).state_dict())


@pytest.mark.parametrize("change", [_sgd_step, _load_other], ids=["sgd_step", "load_state_dict"])
def test_serving_reuses_cast_weights_until_they_change(change):
    """Without autograd the bf16 copies of the f32 weights are made once and
    reused; an update in place or a load makes them again. Each no-grad
    output equals the one that casts every weight anew (the cache emptied).

    Given up on the CPU: the no-grad output bit-equal to the grad-enabled
    one. Under autograd oneDNN adds the bias inside its bf16 convolution
    and rounds once; without it the convolution's epilogue rounds after the
    convolution and again after the bias, as the card does on both paths.
    ``test_torch_conv_epilogue.py::
    test_no_grad_forward_equals_the_grad_enabled_forward`` holds the two
    within the bf16 tolerances here, and on the card
    ``test_torch_cuda.py::test_predictions_equal_the_grad_enabled_forwards``
    holds them bit-equal."""
    model = _ssd7_bf16(seed=0)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32) * 255)

    def uncached():
        kept = dict(model._cast_cache)
        model._cast_cache.clear()
        try:
            with torch.no_grad():
                return model(x)
        finally:
            model._cast_cache.clear()
            model._cast_cache.update(kept)

    with torch.no_grad():
        first = model(x)
        copies = {k: v[2] for k, v in model._cast_cache.items()}
        again = model(x)
    assert len(copies) == 7 + 4  # the convs and the fused heads
    assert all(model._cast_cache[k][2] is v for k, v in copies.items())
    assert all(w.dtype == torch.bfloat16 for w, _ in copies.values())
    assert torch.equal(first, again) and torch.equal(first, uncached())

    change(model, x)
    with torch.inference_mode():  # the predictor's mode
        served = model(x)
    with torch.no_grad():
        after = model(x)
    assert all(model._cast_cache[k][2] is not v for k, v in copies.items())
    assert torch.equal(served, after) and torch.equal(after, uncached())
    assert not torch.equal(after, first)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_bf16_compute_keeps_f32_master_weights():
    """Parameters stay f32 under bf16 compute, as flax keeps them: an SGD
    update of lr * g at lr 1e-4 moves the f32 weights, where most of it is
    below half a bf16 ulp and a bf16 copy of the weights would not move."""
    from ssd_keras_torch.loss import SSDLoss
    from ssd_keras_torch.train import make_train_step, sgd_with_momentum

    model, _ = ssd_300(SSDConfig.ssd300(n_classes=20), compute_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        model.conv1_1.weight.mul_(0.01)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 300, 300, 3).astype(np.float32) * 255)
    y_true = torch.zeros(1, 8732, 33)
    y_true[..., 0] = 1.0
    y_true[0, ::97, 0], y_true[0, ::97, 7] = 0.0, 1.0  # 91 positives
    y_true[..., -8:] = torch.from_numpy(model.anchors8).float()
    opt = sgd_with_momentum(model.parameters(), learning_rate=1e-4, momentum=0.9)
    metrics = make_train_step(model, opt, SSDLoss(), l2_reg=5e-4)(x, y_true)
    assert torch.isfinite(metrics["loss"])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    w_old, w_new = before["fc7.weight"], model.fc7.weight.detach()
    moved = w_new != w_old
    bf16_stuck = (w_old.bfloat16().float() + (w_new - w_old)).bfloat16() == w_old.bfloat16()
    assert moved.float().mean() > 0.9
    assert (moved & bf16_stuck).float().mean() > 0.5
