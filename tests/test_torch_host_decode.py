"""The port's host (NumPy) decoders, its NumPy IoU and its host C++ against
the JAX package's, on the same seeded inputs.

* ``ops/boxes.py``: ``iou_np`` / ``intersection_area_np`` against the JAX
  package's ``iou`` / ``intersection_area`` with ``xp=np``: equal.
* ``decoder.py``: the ragged lists of ``decode_detections``,
  ``decode_detections_fast`` and ``decode_detections_debug`` on one y_pred
  (SSD300 anchors, VOC-21 and COCO-81, top_k 200 and 'all', each
  ``border_pixels``): the same rows in the same order, values within 1e-6.
* ``native/``: each entry equal to the JAX package's native library and to
  the NumPy loop (the plain version).
"""

import numpy as np
import pytest
import torch

from ssd_keras_tpu import decoder as jax_decoder
from ssd_keras_tpu import native as jax_native
from ssd_keras_tpu.eval import Evaluator as JaxEvaluator
from ssd_keras_tpu.ops import boxes as jax_boxes
from ssd_keras_torch import decoder as port_decoder
from ssd_keras_torch import native
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.eval import Evaluator
from ssd_keras_torch.models import ssd300_predictor_sizes
from ssd_keras_torch.ops import boxes as port_boxes

torch.set_num_threads(2)

BORDERS = ["half", "include", "exclude"]


def _boxes(rng, n, frame=100.0):
    xy = rng.rand(n, 2) * frame
    wh = 1 + rng.rand(n, 2) * frame / 3
    return np.concatenate([xy, xy + wh], axis=1)


@pytest.mark.parametrize("border_pixels", BORDERS)
@pytest.mark.parametrize("mode", ["outer_product", "element-wise"])
@pytest.mark.parametrize("coords", ["corners", "centroids", "minmax"])
def test_numpy_iou_equals_jax(coords, mode, border_pixels):
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 7), _boxes(rng, 7 if mode == "element-wise" else 5)
    for dtype in (np.float32, np.float64):
        a, b = a.astype(dtype), b.astype(dtype)
        kw = dict(coords=coords, mode=mode, border_pixels=border_pixels)
        got = port_boxes.iou_np(a, b, **kw)
        np.testing.assert_array_equal(got, jax_boxes.iou(a, b, xp=np, **kw))
        got = port_boxes.intersection_area_np(a, b, **kw)
        np.testing.assert_array_equal(got, jax_boxes.intersection_area(a, b, xp=np, **kw))
        assert got.dtype == dtype


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


def _assert_same_lists(got, expected):
    assert len(got) == len(expected)
    for g, e in zip(got, expected):
        assert g.shape == e.shape and g.dtype == e.dtype
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-6)


_GEOMETRY = dict(input_coords="centroids", normalize_coords=True, img_height=300, img_width=300)


@pytest.mark.parametrize("border_pixels", BORDERS)
@pytest.mark.parametrize("top_k", [200, "all"])
@pytest.mark.parametrize("n_classes", [20, 80])
def test_decode_detections_equals_jax(n_classes, top_k, border_pixels):
    y_pred = _y_pred(n_classes, logit_scale=4.0)
    kw = dict(confidence_thresh=0.1, iou_threshold=0.45, top_k=top_k,
              border_pixels=border_pixels, **_GEOMETRY)
    expected = jax_decoder.decode_detections(y_pred, **kw)
    got = port_decoder.decode_detections(y_pred, **kw)
    assert sum(len(e) for e in expected) > 100
    _assert_same_lists(got, expected)


@pytest.mark.parametrize("border_pixels", BORDERS)
@pytest.mark.parametrize("top_k", [200, "all"])
@pytest.mark.parametrize("n_classes", [20, 80])
def test_decode_detections_fast_equals_jax(n_classes, top_k, border_pixels):
    y_pred = _y_pred(n_classes, seed=1, logit_scale=3.0)
    kw = dict(confidence_thresh=0.3, iou_threshold=0.45, top_k=top_k,
              border_pixels=border_pixels, **_GEOMETRY)
    expected = jax_decoder.decode_detections_fast(y_pred, **kw)
    got = port_decoder.decode_detections_fast(y_pred, **kw)
    assert sum(len(e) for e in expected) > 50
    _assert_same_lists(got, expected)


@pytest.mark.parametrize("variance_encoded_in_target", [False, True])
@pytest.mark.parametrize("coords", ["centroids", "minmax", "corners"])
def test_decode_detections_debug_and_pred_layers_equal_jax(coords, variance_encoded_in_target):
    y_pred = _y_pred(20, seed=2, logit_scale=4.0)
    kw = dict(confidence_thresh=0.2, iou_threshold=0.45, top_k=200, input_coords=coords,
              normalize_coords=True, img_height=300, img_width=300,
              variance_encoded_in_target=variance_encoded_in_target)
    expected = jax_decoder.decode_detections_debug(y_pred, **kw)
    got = port_decoder.decode_detections_debug(y_pred, **kw)
    _assert_same_lists(got, expected)
    np.testing.assert_allclose(port_decoder.decode_offsets_np(y_pred, coords, True, 300, 300),
                               jax_decoder.decode_offsets(y_pred, coords, True, 300, 300, xp=np),
                               rtol=0, atol=0)
    cfg = SSDConfig.ssd300()
    sizes = ssd300_predictor_sizes(300, 300)
    counts = port_decoder.get_num_boxes_per_pred_layer(sizes, cfg.aspect_ratios,
                                                       cfg.two_boxes_for_ar1)
    assert counts == jax_decoder.get_num_boxes_per_pred_layer(
        sizes, cfg.aspect_ratios, cfg.two_boxes_for_ar1)
    assert sum(counts) == 8732
    assert port_decoder.get_pred_layers(got, counts) == jax_decoder.get_pred_layers(got, counts)
    with pytest.raises(ValueError, match="out of bounds"):
        port_decoder.get_pred_layers([np.array([[9000.0, 1, 0.5, 0, 0, 1, 1]])], counts)


def _nms_rows(rng, n):
    boxes = _boxes(rng, n, frame=60.0)
    scores = rng.rand(n)
    if n > 1:
        scores[::9] = scores[1::9][: len(scores[::9])]  # ties
    return np.concatenate([scores[:, None], boxes], axis=1)


@pytest.mark.parametrize("border_pixels", BORDERS)
@pytest.mark.parametrize("n", [1, 2, 57, 300])
def test_greedy_nms_native_equals_jax_and_numpy(n, border_pixels):
    """Selection order included. The rows are f32-representable, so the
    native f32 IoU and the NumPy f64 one decide alike away from the
    threshold."""
    rows = _nms_rows(np.random.RandomState(n), n).astype(np.float32).astype(np.float64)
    got = port_decoder.greedy_nms(rows, 0.45, border_pixels)
    np.testing.assert_array_equal(got, jax_decoder.greedy_nms(rows, 0.45, border_pixels))
    np.testing.assert_array_equal(got, port_decoder.greedy_nms_numpy(rows, 0.45, border_pixels))
    assert 0 < len(got) <= n


def test_native_entries_equal_jax_native():
    assert jax_native.available()
    rng = np.random.RandomState(5)
    a, b = _boxes(rng, 40).astype(np.float32), _boxes(rng, 30).astype(np.float32)
    for d in (0, 1, -1):
        got = native.iou_matrix(a, b, d)
        np.testing.assert_array_equal(got, jax_native.iou_matrix(a, b, d))
        np.testing.assert_allclose(got, port_boxes.iou_np(a, b, coords="corners",
                                                          border_pixels={0: "half", 1: "include",
                                                                         -1: "exclude"}[d]),
                                   rtol=1e-5, atol=1e-6)
        rows = _nms_rows(rng, 200)
        np.testing.assert_array_equal(
            native.greedy_nms_indices(rows[:, 0], rows[:, 1:], 0.5, d),
            jax_native.greedy_nms_indices(rows[:, 0], rows[:, 1:], 0.5, d))


class _Gen:
    """What the evaluator's matching reads of a data generator."""

    def __init__(self, labels, neutral):
        self.labels, self.eval_neutral = labels, neutral
        self.image_ids = [f"img{i}" for i in range(len(labels))]


def _matching_case(seed, with_neutral):
    """Ground truth of 12 images (some empty) over 3 classes, and per class
    predictions near it (jittered copies, duplicates and misses)."""
    rng = np.random.RandomState(seed)
    labels, neutral = [], []
    for i in range(12):
        k = 0 if i % 5 == 4 else rng.randint(1, 6)
        boxes = np.round(_boxes(rng, k))
        labels.append(np.concatenate([rng.randint(1, 4, (k, 1)), boxes], axis=1))
        neutral.append(list(rng.rand(k) < 0.2))
    preds = [[] for _ in range(4)]
    for i, lab in enumerate(labels):
        for row in lab:
            for _ in range(rng.randint(0, 3)):
                box = row[1:] + rng.randn(4) * 3
                preds[int(row[0])].append((f"img{i}", float(np.float32(rng.rand())),
                                           *np.round(box, 1)))
        for _ in range(2):  # false detections
            preds[rng.randint(1, 4)].append((f"img{i}", float(np.float32(rng.rand())),
                                             *np.round(_boxes(rng, 1)[0], 1)))
    return _Gen(labels, neutral if with_neutral else None), preds


@pytest.mark.parametrize("border_pixels", BORDERS)
@pytest.mark.parametrize("with_neutral", [False, True])
def test_match_predictions_native_equals_jax_and_numpy(with_neutral, border_pixels):
    gen, preds = _matching_case(7, with_neutral)
    results = []
    for cls, method in ((Evaluator, "match_predictions"), (Evaluator, "match_predictions_numpy"),
                        (JaxEvaluator, "match_predictions")):
        kw = dict(device="cpu") if cls is Evaluator else {}
        ev = cls(model=None, n_classes=3, data_generator=gen, **kw)
        ev.prediction_results = preds
        results.append(getattr(ev, method)(border_pixels=border_pixels, ret=True))
    assert sum(int(t.sum()) for t in results[0][0][1:]) > 5
    for other in results[1:]:
        for got, expected in zip(results[0], other):
            for g, e in zip(got[1:], expected[1:]):
                np.testing.assert_array_equal(g, e)


def test_native_entries_reject_what_the_c_code_would_misread():
    boxes = np.zeros((3, 4), np.float32)
    with pytest.raises(ValueError, match="boxes"):
        native.greedy_nms_indices(np.zeros(4), boxes, 0.45)
    with pytest.raises(ValueError, match="boxes1"):
        native.iou_matrix(np.zeros((3, 5)), boxes)
    ok = dict(pred_img=np.array([0, 1]), pred_boxes=np.zeros((2, 4)),
              gt_offsets=np.array([0, 1, 3]), gt_boxes=boxes, gt_neutral=None,
              iou_threshold=0.5, border_delta=0)
    tp, fp = native.match_predictions_class(**ok)
    assert tp.shape == fp.shape == (2,)
    for bad, match in ((dict(pred_img=np.array([0, 2])), "image index"),
                       (dict(gt_offsets=np.array([0, 1, 4])), "gt_offsets"),
                       (dict(gt_offsets=np.array([0, 2, 1, 3])), "gt_offsets"),
                       (dict(pred_boxes=np.zeros((3, 4))), "pred_boxes"),
                       (dict(gt_neutral=np.zeros(2, np.uint8)), "gt_neutral")):
        with pytest.raises(ValueError, match=match):
            native.match_predictions_class(**{**ok, **bad})
