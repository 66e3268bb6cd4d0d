"""The port's fixed-shape decoders against the JAX package's, on one y_pred.

The same ``y_pred`` (made with numpy from a seed, with the real SSD300 anchor
tensor) goes through JAX ``decode_detections_fixed(nms_impl='scan',
topk_impl='sort')`` — the exact scan NMS and the tie-stable ``lax.top_k``
that the port mirrors — and through ``ssd_keras_torch.decoder``.

Pass criteria: the same rows in the same order with the same class ids, and
scores and boxes within rtol 1e-5. Boxes also get atol 1e-4 px: the two
sides' ``exp`` may differ in the last ulp, which is relative error near a
coordinate of 0. Any NMS or threshold decision that flipped would move a
whole row, far beyond either tolerance.
"""

import numpy as np
import pytest
import torch

from ssd_keras_tpu import decoder as jax_decoder
from ssd_keras_torch import decoder as port_decoder
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.models import ssd300_predictor_sizes

torch.set_num_threads(2)

_GEOMETRY = dict(input_coords="centroids", normalize_coords=True, img_height=300, img_width=300)


def _y_pred(n_classes, batch=2, seed=0, logit_scale=2.5):
    """(B, 8732, C + 12) f32: softmax scores, offsets, SSD300 anchors."""
    dataset = "coco" if n_classes == 80 else "voc"
    cfg = SSDConfig.ssd300(n_classes=n_classes, dataset=dataset)
    anchors = cfg.anchor_tensor(ssd300_predictor_sizes(300, 300)).astype(np.float32)
    rng = np.random.RandomState(seed)
    n, c = anchors.shape[0], n_classes + 1
    logits = rng.randn(batch, n, c).astype(np.float32) * logit_scale
    e = np.exp(logits - logits.max(-1, keepdims=True))
    confs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    offsets = rng.randn(batch, n, 4).astype(np.float32) * 0.5
    return np.concatenate(
        [confs, offsets, np.broadcast_to(anchors, (batch, n, 8))], axis=-1
    ).astype(np.float32)


def _assert_same_detections(got, expected):
    assert got.shape == expected.shape
    np.testing.assert_array_equal(got[..., 0], expected[..., 0])  # class ids, row order
    np.testing.assert_allclose(got[..., 1], expected[..., 1], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[..., 2:], expected[..., 2:], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize(
    "n_classes, compact_pool, kwargs",
    [
        (20, "auto", {}),
        (20, None, {}),
        (80, "auto", {}),
        (80, None, {}),
        # A pool larger than the per-class cap: the cumsum cap runs.
        (20, None, dict(nms_max_output_size=50, nms_candidates=100)),
        (20, "auto", dict(border_pixels="include")),
    ],
)
def test_decode_detections_fixed_matches_jax(n_classes, compact_pool, kwargs):
    y_pred = _y_pred(n_classes)
    common = dict(confidence_thresh=0.01, iou_threshold=0.45, top_k=200,
                  compact_pool=compact_pool, **_GEOMETRY, **kwargs)
    expected = np.asarray(jax_decoder.decode_detections_fixed(
        y_pred, nms_impl="scan", topk_impl="sort", **common))
    got = port_decoder.decode_detections_fixed(torch.from_numpy(y_pred), **common).numpy()
    assert (expected[..., 1] > 0).sum() > 100  # a realistic number of detections
    _assert_same_detections(got, expected)


@pytest.mark.parametrize("n_classes", [20, 80])
def test_decode_detections_fast_fixed_matches_jax(n_classes):
    y_pred = _y_pred(n_classes, seed=1, logit_scale=3.0)
    common = dict(confidence_thresh=0.3, iou_threshold=0.45, top_k=200, **_GEOMETRY)
    expected = np.asarray(jax_decoder.decode_detections_fast_fixed(
        y_pred, nms_impl="scan", topk_impl="sort", **common))
    got = port_decoder.decode_detections_fast_fixed(torch.from_numpy(y_pred), **common).numpy()
    assert (expected[..., 1] > 0).sum() > 50
    _assert_same_detections(got, expected)


@pytest.mark.parametrize("fast", [False, True])
def test_batch_of_one_matches_jax(fast):
    """At batch 1 the per-class gathers return strided tensors; the NMS
    wrapper takes only contiguous ones."""
    y_pred = _y_pred(20, batch=1, seed=2)
    common = dict(confidence_thresh=0.3 if fast else 0.01, iou_threshold=0.45, top_k=200,
                  **_GEOMETRY)
    jax_fn = jax_decoder.decode_detections_fast_fixed if fast else jax_decoder.decode_detections_fixed
    port_fn = port_decoder.decode_detections_fast_fixed if fast else port_decoder.decode_detections_fixed
    expected = np.asarray(jax_fn(y_pred, nms_impl="scan", topk_impl="sort", **common))
    got = port_fn(torch.from_numpy(y_pred), **common).numpy()
    _assert_same_detections(got, expected)


def test_few_boxes_pad_to_top_k():
    """Fewer candidates than top_k: zero rows pad the output."""
    y_pred = _y_pred(20)[:, :60]
    common = dict(confidence_thresh=0.01, iou_threshold=0.45, top_k=200, **_GEOMETRY)
    expected = np.asarray(jax_decoder.decode_detections_fixed(
        y_pred, nms_impl="scan", topk_impl="sort", **common))
    got = port_decoder.decode_detections_fixed(torch.from_numpy(y_pred), **common).numpy()
    assert got.shape == (2, 200, 6)
    _assert_same_detections(got, expected)


@pytest.mark.parametrize("coords", ["centroids", "minmax", "corners"])
def test_decode_offsets_matches_jax(coords):
    y_pred = _y_pred(20, batch=1)
    expected = jax_decoder.decode_offsets(y_pred, coords, True, 300, 300)
    got = port_decoder.decode_offsets(torch.from_numpy(y_pred), coords, True, 300, 300)
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-6, atol=1e-4)


def test_compact_pool_resolution_follows_the_code():
    """'auto' is M = 512 whenever N > 512, at any class count."""
    resolve = port_decoder._resolve_compact_pool
    assert resolve("auto", 8732, 400) == jax_decoder._resolve_compact_pool("auto", 8732, 21, 400) == 512
    assert resolve("auto", 500, 400) == 0
    assert resolve(None, 8732, 400) == 0
    assert resolve(100, 8732, 400) == 400
