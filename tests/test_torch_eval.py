"""The port's Evaluator: the cases of ``tests/test_eval.py``, and the whole
evaluation against the JAX package's ``Evaluator`` on the same data and the
same stream of predictions.

The stream is a noisy oracle (``chip_smoke.noisy_oracle``, the stream the
card's smoke run evaluates): the port's encoder's targets for SynthVOC
images (SSD300 anchors, 300x300, so the evaluator's resize is the identity
on both sides) with seeded noise on the scores and offsets, fed to both
evaluators in 'training' mode. Pass criteria: ``prediction_results`` equal
(ids and classes exactly, confidences within 1e-6, boxes within 0.1 px,
the grain of the evaluator's rounding), TP/FP arrays equal, per-class AP
and mAP within 1e-9 in 'sample' and 'integrate' modes, with and without
neutral boxes, and the VOC results files byte-equal.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import StreamModel, noisy_oracle
from ssd_keras_tpu.data import DataGenerator as JaxDataGenerator
from ssd_keras_tpu.eval import Evaluator as JaxEvaluator
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.data import DataGenerator, SynthVOC
from ssd_keras_torch.encoder import SSDInputEncoder, pad_labels
from ssd_keras_torch.eval import Evaluator
from ssd_keras_torch.models import ssd300_predictor_sizes, ssd_7

torch.set_num_threads(2)


def _dataset(tmp_path, labels, neutral=None, h=64, w=64):
    fns = []
    for i in range(len(labels)):
        fn = tmp_path / f"im{i}.jpg"
        Image.fromarray(
            np.random.RandomState(i).randint(0, 255, (h, w, 3), dtype=np.uint8)
        ).save(fn)
        fns.append(str(fn))
    return DataGenerator(
        filenames=fns,
        labels=[np.asarray(l, dtype=np.float64) for l in labels],
        image_ids=[str(i) for i in range(len(labels))],
        eval_neutral=neutral,
        load_images_into_memory=True,
    )


class _FakeEvaluator(Evaluator):
    """Evaluator with injected predictions (skips the model forward)."""

    def __init__(self, n_classes, data_generator, predictions):
        super().__init__(model=None, n_classes=n_classes, data_generator=data_generator,
                         device="cpu")
        self.prediction_results = predictions


def _run(ev, **kwargs):
    ev.get_num_gt_per_class(verbose=False, **{k: v for k, v in kwargs.items()
                                              if k == "ignore_neutral_boxes"})
    ev.match_predictions(verbose=False, **kwargs)
    ev.compute_precision_recall()
    ev.compute_average_precisions()
    return ev.compute_mean_average_precision()


def test_perfect_predictions_map_one(tmp_path):
    labels = [[[1, 10, 10, 30, 30]], [[1, 20, 20, 40, 40], [2, 5, 5, 15, 15]]]
    gen = _dataset(tmp_path, labels)
    preds = [[],
             [("0", 0.9, 10, 10, 30, 30), ("1", 0.8, 20, 20, 40, 40)],
             [("1", 0.95, 5, 5, 15, 15)]]
    assert _run(_FakeEvaluator(2, gen, preds)) == pytest.approx(1.0)


def test_duplicate_detection_is_fp(tmp_path):
    gen = _dataset(tmp_path, [[[1, 10, 10, 30, 30]]])
    ev = _FakeEvaluator(1, gen, [[], [("0", 0.9, 10, 10, 30, 30), ("0", 0.8, 11, 11, 30, 30)]])
    _run(ev)
    np.testing.assert_array_equal(ev.true_positives[1], [1, 0])
    np.testing.assert_array_equal(ev.false_positives[1], [0, 1])


def test_low_iou_is_fp(tmp_path):
    gen = _dataset(tmp_path, [[[1, 10, 10, 30, 30]]])
    assert _run(_FakeEvaluator(1, gen, [[], [("0", 0.9, 40, 40, 60, 60)]])) == 0.0


def test_neutral_boxes_skipped(tmp_path):
    labels = [[[1, 10, 10, 30, 30], [1, 40, 40, 60, 60]]]
    gen = _dataset(tmp_path, labels, neutral=[[False, True]])
    # A confident detection of the neutral box: neither TP nor FP.
    preds = [[], [("0", 0.9, 40, 40, 60, 60), ("0", 0.8, 10, 10, 30, 30)]]
    ev = _FakeEvaluator(1, gen, preds)
    _run(ev, ignore_neutral_boxes=True)
    np.testing.assert_array_equal(ev.true_positives[1], [0, 1])
    np.testing.assert_array_equal(ev.false_positives[1], [0, 0])
    assert ev.num_gt_per_class[1] == 1  # the neutral GT is not counted


def test_sample_vs_integrate_modes(tmp_path):
    gen = _dataset(tmp_path, [[[1, 10, 10, 30, 30], [1, 40, 40, 60, 60]]])
    preds = [[], [("0", 0.9, 10, 10, 30, 30), ("0", 0.5, 40, 40, 60, 60)]]
    ev = _FakeEvaluator(1, gen, preds)
    ev.get_num_gt_per_class(verbose=False)
    ev.match_predictions(verbose=False)
    ev.compute_precision_recall()
    ev.compute_average_precisions(mode="sample", num_recall_points=11)
    ap_sample = ev.average_precisions[1]
    ev.compute_average_precisions(mode="integrate")
    # The reference sums rectangles only between unique recall values.
    assert ap_sample == pytest.approx(1.0)
    assert ev.average_precisions[1] == pytest.approx(0.5)


def test_write_predictions_to_txt(tmp_path):
    gen = _dataset(tmp_path, [[[1, 10, 10, 30, 30]]])
    ev = _FakeEvaluator(1, gen, [[], [("000007", 0.876543, 10.0, 10.0, 30.0, 30.0)]])
    prefix = str(tmp_path / "comp3_det_test_")
    ev.write_predictions_to_txt(classes=["bg", "car"], out_file_prefix=prefix)
    content = (tmp_path / "comp3_det_test_car.txt").read_text().strip()
    assert content.startswith("000007 0.8765 ")


def test_end_to_end_with_constant_model(tmp_path):
    """The whole __call__ path with a fake 'inference'-mode model, whose
    batches arrive as tensors on the evaluator's device."""
    gen = _dataset(tmp_path, [[[1, 8, 8, 40, 40]], [[1, 16, 16, 48, 48]]])
    seen = []

    def fake_model(batch):
        seen.append((batch.device.type, batch.dtype, tuple(batch.shape)))
        out = torch.zeros((len(batch), 200, 6))
        out[0, 0] = torch.tensor([1, 0.9, 8, 8, 40, 40])
        out[1, 0] = torch.tensor([1, 0.9, 16, 16, 48, 48])
        return out

    ev = Evaluator(model=fake_model, n_classes=1, data_generator=gen, model_mode="inference",
                   device="cpu")
    assert ev(img_height=64, img_width=64, batch_size=2, verbose=False) == pytest.approx(1.0)
    assert seen == [("cpu", torch.uint8, (2, 64, 64, 3))]


def test_device_decode_matches_host_decode_path(tmp_path):
    """mAP and per-class counts identical with device or host decoding of
    'training'-mode predictions, at a threshold where fewer than the
    device decoder's candidate pool are eligible ('half' border pixels)."""
    cfg = SSDConfig.ssd7(n_classes=2, img_height=64, img_width=64)
    model, _ = ssd_7(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gen = _dataset(tmp_path, [[[1, 10, 10, 30, 30]], [[2, 20, 20, 50, 50]]])
    maps = []
    for device_decode in (True, False):
        ev = Evaluator(model=model, n_classes=2, data_generator=gen, model_mode="training",
                       device="cpu")
        ev.predict_on_dataset(img_height=64, img_width=64, batch_size=2, verbose=False,
                              decoding_confidence_thresh=0.6, device_decode=device_decode,
                              decoding_border_pixels="half")
        maps.append((_run(ev), tuple(len(p) for p in ev.prediction_results)))
    assert maps[0][0] == pytest.approx(maps[1][0])
    assert maps[0][1] == maps[1][1]


# --------------------------------------------------------------------------- #
# Against the JAX package's Evaluator on a noisy oracle
# --------------------------------------------------------------------------- #

N_IMAGES, BATCH = 16, 4


@pytest.fixture(scope="module")
def oracle_stream():
    """(images, labels, y stream (N, 8732, 33) f32, eval-neutral flags)."""
    images, labels = SynthVOC(N_IMAGES, image_size=300, split="val", seed=4).materialize()
    cfg = SSDConfig.ssd300()
    enc = SSDInputEncoder(cfg, ssd300_predictor_sizes(300, 300), max_gt_boxes=8, device="cpu")
    y = noisy_oracle(enc.encode_padded(*pad_labels(labels, 8)).numpy(), seed=5)
    neutral = [list(np.random.RandomState(6).rand(len(lab)) < 0.25) for lab in labels]
    return images, labels, y, neutral


_RUNS = {}


def _evaluate(kind, oracle, tmp_path, with_neutral, device_decode, mode):
    """The evaluator of ``kind`` after its predictions, matching and the AP
    of ``mode``; the predictions and matching are made once per
    (kind, with_neutral, device_decode) and kept."""
    key = (kind, with_neutral, device_decode)
    if key not in _RUNS:
        _RUNS[key] = _predict_and_match(kind, oracle, with_neutral, device_decode)
    ev = _RUNS[key]
    ev.compute_average_precisions(mode=mode)
    ev.compute_mean_average_precision()
    prefix = tmp_path / kind
    prefix.mkdir(exist_ok=True)
    ev.write_predictions_to_txt(out_file_prefix=str(prefix / "det_"))
    return ev


def _predict_and_match(kind, oracle, with_neutral, device_decode):
    images, labels, y, neutral = oracle
    gen_cls, ev_cls = (DataGenerator, Evaluator) if kind == "port" else (JaxDataGenerator,
                                                                        JaxEvaluator)
    gen = gen_cls(labels=[np.asarray(l, np.float64) for l in labels],
                  image_ids=list(range(N_IMAGES)), eval_neutral=neutral if with_neutral else None)
    gen.images = list(images)
    gen.dataset_size = N_IMAGES
    gen.dataset_indices = np.arange(N_IMAGES, dtype=np.int32)
    kw = dict(device="cpu") if kind == "port" else {}
    stream = torch.from_numpy(y) if kind == "port" else y
    ev = ev_cls(model=StreamModel(stream), n_classes=20, data_generator=gen,
                model_mode="training", **kw)
    ev.predict_on_dataset(img_height=300, img_width=300, batch_size=BATCH, verbose=False,
                          device_decode=device_decode)
    ev.get_num_gt_per_class(ignore_neutral_boxes=True, verbose=False)
    ev.match_predictions(ignore_neutral_boxes=True, verbose=False)
    ev.compute_precision_recall()
    return ev


@pytest.mark.parametrize("mode", ["sample", "integrate"])
@pytest.mark.parametrize("with_neutral", [False, True])
@pytest.mark.parametrize("device_decode", [True, False])
def test_noisy_oracle_equals_jax_evaluator(oracle_stream, tmp_path, device_decode, with_neutral,
                                           mode):
    port = _evaluate("port", oracle_stream, tmp_path, with_neutral, device_decode, mode)
    jax = _evaluate("jax", oracle_stream, tmp_path, with_neutral, device_decode, mode)
    n_det = sum(len(p) for p in jax.prediction_results)
    assert n_det > 100
    for got, expected in zip(port.prediction_results, jax.prediction_results):
        assert len(got) == len(expected)
        for g, e in zip(got, expected):
            assert g[0] == e[0]  # image id
            assert abs(g[1] - e[1]) <= 1e-6
            np.testing.assert_allclose(g[2:], e[2:], rtol=0, atol=0.1)
    for got, expected in ((port.true_positives, jax.true_positives),
                          (port.false_positives, jax.false_positives)):
        for g, e in zip(got[1:], expected[1:]):
            np.testing.assert_array_equal(g, e)
    np.testing.assert_allclose(port.average_precisions, jax.average_precisions, rtol=0,
                               atol=1e-9)
    assert 0.0 < jax.mean_average_precision < 1.0
    assert abs(port.mean_average_precision - jax.mean_average_precision) <= 1e-9
    for cls in range(1, 21):
        name = f"det_{cls:04d}.txt"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_evaluator_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(model=None, n_classes=1, data_generator=None)
