"""The port's SSD512 against the flax model, on shared weights.

Weights come from flax ``init`` and reach the port through
``weights_io.from_flax_params``; inputs are numpy arrays from a seed.
conv1_1 is scaled by 1/100 on both sides, as in ``test_torch_models.py``, so
the scores and offsets lie in a trained detector's range. One flax forward
at 512x512 serves the whole file.
"""

import jax
import numpy as np
import pytest
import torch

from ssd_keras_tpu import decoder as jax_decoder
from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.models import ssd512_predictor_sizes as jax_sizes
from ssd_keras_tpu.models import ssd_512 as jax_ssd_512
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.models import ssd512_predictor_sizes, ssd_512
from ssd_keras_torch.weights_io import from_flax_params, to_flax_params

torch.set_num_threads(2)

_GEOMETRY = dict(input_coords="centroids", normalize_coords=True, img_height=512, img_width=512)


@pytest.fixture(scope="module")
def ssd512_shared():
    """(flax params as numpy with conv1_1 scaled, the image, flax y_pred,
    the port's y_pred, the port's model)."""
    model, _ = jax_ssd_512(JaxSSDConfig.ssd512(n_classes=20))
    x = np.random.RandomState(3).rand(1, 512, 512, 3).astype(np.float32) * 255
    params = jax.tree_util.tree_map(
        np.asarray, dict(model.init(jax.random.PRNGKey(0), x)["params"]))
    params["conv1_1"]["kernel"] = params["conv1_1"]["kernel"] / 100.0
    expected = np.asarray(jax.jit(model.apply)({"params": params}, x))
    port, _ = ssd_512(SSDConfig.ssd512(n_classes=20), device="cpu")
    port.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    return params, x, expected, got, port


@pytest.mark.parametrize("hw", [(512, 512), (600, 800), (768, 768)])
def test_predictor_sizes_equal_jax(hw):
    assert ssd512_predictor_sizes(*hw) == jax_sizes(*hw)


def test_anchor_tensor_equals_jax():
    sizes = ssd512_predictor_sizes(512, 512)
    got = SSDConfig.ssd512(n_classes=20).anchor_tensor(sizes)
    expected = JaxSSDConfig.ssd512(n_classes=20).anchor_tensor(sizes)
    assert got.shape == (24564, 8)
    np.testing.assert_array_equal(got, expected)


def test_flax_conversion_round_trips(ssd512_shared):
    """SSD512's extra names (conv10_1, conv10_2 and the 7th head) map both
    ways, and every key and shape of the module matches."""
    params, _, _, _, port = ssd512_shared
    state = from_flax_params(params)
    assert set(state) == set(port.state_dict())
    assert state["conv10_2.weight"].shape == (256, 128, 4, 4)
    assert state["conv10_2_mbox_conf.weight"].shape == (4 * 21, 256, 3, 3)
    back, stats = to_flax_params(port.state_dict())
    assert stats == {} and set(back) == set(params)
    for layer, tensors in params.items():
        for key, value in tensors.items():
            np.testing.assert_array_equal(back[layer][key], value)


def test_ssd512_y_pred_matches_flax(ssd512_shared):
    """f32, batch 1, 512x512, within 1e-3: the frameworks sum the
    convolutions in other orders (see test_torch_models.py); a wrong layer,
    padding or box order errs by orders more."""
    _, _, expected, got, _ = ssd512_shared
    assert got.shape == expected.shape == (1, 24564, 33)
    assert 0.05 < expected[..., 1:21].max() < 0.999  # not saturated
    np.testing.assert_allclose(got, expected, rtol=1e-3, atol=1e-3)


def _assert_same_detections(got, expected):
    assert got.shape == expected.shape
    np.testing.assert_array_equal(got[..., 0], expected[..., 0])
    np.testing.assert_allclose(got[..., 1], expected[..., 1], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[..., 2:], expected[..., 2:], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["inference", "inference_fast"])
def test_inference_modes_equal_jax_decode_of_the_same_y_pred(ssd512_shared, mode):
    """The port's SSD512 in ``mode`` against the JAX package's decoder on
    the port's own y_pred: 24564 anchors compacted to 512, then the
    per-class (or, fast, the one global) NMS."""
    params, x, _, y_pred, _ = ssd512_shared
    cfg = SSDConfig.ssd512(n_classes=20)
    model, _ = ssd_512(cfg, mode=mode, device="cpu")
    model.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    fn = (jax_decoder.decode_detections_fixed if mode == "inference"
          else jax_decoder.decode_detections_fast_fixed)
    expected = np.asarray(fn(
        y_pred, confidence_thresh=cfg.confidence_thresh, iou_threshold=cfg.iou_threshold,
        top_k=cfg.top_k, nms_max_output_size=cfg.nms_max_output_size, nms_impl="scan",
        topk_impl="sort", **_GEOMETRY))
    assert (expected[..., 1] > 0).sum() >= 10
    _assert_same_detections(got, expected)
