"""The port's target encoder against the JAX package's.

Labels are jittered (non-integer) boxes from a seed: XLA on the CPU may
contract IoU arithmetic into FMAs that NumPy and torch do not, which flips
matches at exact geometric ties, and jitter removes such ties. Class columns
(the one-hot rows, all-zero rows of the neutral zone included) must be
equal; offsets agree within 1e-5 (f32 ``log`` and division may differ by an
ulp between XLA and torch, on offsets of magnitude <= ~10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_keras_tpu import encoder as jax_encoder
from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.encoder import DegenerateBoxError, SSDInputEncoder, encode_targets, pad_labels
from ssd_keras_torch.models import ssd7_predictor_sizes, ssd300_predictor_sizes

torch.set_num_threads(2)

OFFSET_TOL = 1e-5
MAX_GT = 8


def _labels(seed, size, n_classes, counts):
    """Ragged list of (k, 5) jittered boxes inside a size x size frame."""
    rng = np.random.RandomState(seed)
    out = []
    for k in counts:
        wh = rng.uniform(0.08, 0.7, (k, 2)) * size
        x0 = rng.uniform(0, 1, (k, 1)) * (size - wh[:, :1])
        y0 = rng.uniform(0, 1, (k, 1)) * (size - wh[:, 1:])
        cls = rng.randint(1, n_classes + 1, (k, 1))
        out.append(np.concatenate([cls, x0, y0, x0 + wh[:, :1], y0 + wh[:, 1:]], axis=1)
                   .astype(np.float32))
    return out


def _configs(model, coords, matching_type):
    if model == "ssd7":
        kw = dict(n_classes=5, img_height=64, img_width=64, coords=coords,
                  matching_type=matching_type)
        return SSDConfig.ssd7(**kw), JaxSSDConfig.ssd7(**kw), ssd7_predictor_sizes(64, 64), 64
    kw = dict(coords=coords, matching_type=matching_type)
    return SSDConfig.ssd300(**kw), JaxSSDConfig.ssd300(**kw), ssd300_predictor_sizes(300, 300), 300


def _assert_targets_equal(got, expected, n_classes_with_bg):
    assert got.shape == expected.shape
    np.testing.assert_array_equal(got[..., :n_classes_with_bg], expected[..., :n_classes_with_bg])
    np.testing.assert_allclose(got[..., -12:-8], expected[..., -12:-8], rtol=0, atol=OFFSET_TOL)
    np.testing.assert_array_equal(got[..., -8:], expected[..., -8:])


ENCODE_CASES = (
    [("ssd7", c, m) for c in ("centroids", "corners", "minmax") for m in ("multi", "bipartite")]
    + [("ssd300", c, "multi") for c in ("centroids", "corners", "minmax")]
    + [("ssd300", "centroids", "bipartite")]
)


@pytest.mark.parametrize("model, coords, matching_type", ENCODE_CASES)
def test_encode_targets_equals_jax(model, coords, matching_type):
    cfg, jax_cfg, sizes, size = _configs(model, coords, matching_type)
    padded, counts = pad_labels(_labels(0, size, cfg.n_classes, [3, MAX_GT]), MAX_GT)
    anchors = cfg.anchor_tensor(sizes).astype(np.float32)
    static = dict(
        n_classes_with_bg=cfg.n_classes_with_background, img_height=size, img_width=size,
        coords=coords, normalize_coords=True, border_pixels="half",
        matching_type=matching_type, pos_iou_threshold=0.5,
        neg_iou_limit=float(cfg.neg_iou_limit), background_id=0,
    )
    expected = np.asarray(jax_encoder.encode_targets(
        jnp.asarray(padded), jnp.asarray(counts), jnp.asarray(anchors), **static))
    got = encode_targets(torch.from_numpy(padded), torch.from_numpy(counts),
                         torch.from_numpy(anchors), **static).numpy()
    _assert_targets_equal(got, expected, cfg.n_classes_with_background)
    classes = got[..., :cfg.n_classes_with_background]
    assert (classes[..., 1:].max(-1) > 0).sum() >= 11  # every box matched something
    if matching_type == "bipartite" or cfg.neg_iou_limit < cfg.pos_iou_threshold:
        # SSD300's neg_iou_limit equals its threshold: multi matching takes
        # every anchor the neutral zone would hold.
        assert (classes.sum(-1) == 0).any()


def test_encoder_call_and_diagnostics_equal_jax():
    """The ragged entry point with an empty image, and ``diagnostics``."""
    cfg, jax_cfg, sizes, size = _configs("ssd7", "centroids", "multi")
    labels = _labels(1, size, cfg.n_classes, [2, 0, 5])
    y, y_matched = SSDInputEncoder(cfg, sizes, max_gt_boxes=MAX_GT, device="cpu")(
        labels, diagnostics=True)
    exp, exp_matched = jax_encoder.SSDInputEncoder(jax_cfg, sizes, max_gt_boxes=MAX_GT)(
        labels, diagnostics=True)
    _assert_targets_equal(y, exp, cfg.n_classes_with_background)
    _assert_targets_equal(y_matched, exp_matched, cfg.n_classes_with_background)
    assert np.all(y_matched[..., -12:-8] == 0)
    assert np.all(y[1, :, 0] == 1) and np.all(y[1, :, -12:-8] == 0)  # the empty image


def test_encode_padded_takes_and_returns_tensors():
    cfg, _, sizes, size = _configs("ssd7", "centroids", "multi")
    encoder = SSDInputEncoder(cfg, sizes, max_gt_boxes=MAX_GT, device="cpu")
    labels = _labels(2, size, cfg.n_classes, [4, 1])
    padded, counts = pad_labels(labels, MAX_GT)
    got = encoder.encode_padded(torch.from_numpy(padded), torch.from_numpy(counts))
    assert isinstance(got, torch.Tensor) and got.shape == (2, 340, 18)
    np.testing.assert_array_equal(got.numpy(), encoder(labels))


@pytest.mark.parametrize("bad_class", [0, 6, -1])
def test_class_ids_outside_range_raise(bad_class):
    cfg, _, sizes, _ = _configs("ssd7", "centroids", "multi")
    encoder = SSDInputEncoder(cfg, sizes, max_gt_boxes=MAX_GT, device="cpu")
    with pytest.raises(ValueError, match="class IDs"):
        encoder([np.array([[bad_class, 1.0, 1.0, 20.0, 20.0]])])


@pytest.mark.parametrize("box", [[10.0, 10.0, 10.0, 20.0], [10.0, 20.0, 30.0, 5.0]])
def test_degenerate_boxes_raise(box):
    cfg, _, sizes, _ = _configs("ssd7", "centroids", "multi")
    encoder = SSDInputEncoder(cfg, sizes, max_gt_boxes=MAX_GT, device="cpu")
    with pytest.raises(DegenerateBoxError):
        encoder([np.array([[1.0] + box])])


def test_pad_labels_truncate_equals_jax():
    labels = _labels(3, 300, 20, [12, 3, 0])
    with pytest.raises(ValueError, match="max_gt"):
        pad_labels(labels, MAX_GT)
    got = pad_labels(labels, MAX_GT, truncate=True)
    expected = jax_encoder.pad_labels(labels, MAX_GT, truncate=True)
    for g, e in zip(got, expected):
        np.testing.assert_array_equal(g, e)
    assert got[1].tolist() == [MAX_GT, 3, 0]
