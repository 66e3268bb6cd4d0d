"""The port's COCO tools against the JAX package's: the vendored
``COCOEvalBBox`` / ``coco_bbox_iou`` (the 12 summary stats equal on a seeded
GT/detection pair) and ``predict_all_to_json`` / ``get_coco_category_maps``
(the same JSON, in the same order, from the same data and model outputs),
plus the cases of ``tests/test_coco.py`` on the port.
"""

import json

import numpy as np
import pytest
import torch

from ssd_keras_tpu.data import DataGenerator as JaxDataGenerator
from ssd_keras_tpu.eval import COCOEvalBBox as JaxCOCOEvalBBox
from ssd_keras_tpu.eval import coco_bbox_iou as jax_coco_bbox_iou
from ssd_keras_tpu.eval import predict_all_to_json as jax_predict_all_to_json
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.data import DataGenerator, SynthVOC
from ssd_keras_torch.encoder import SSDInputEncoder, pad_labels
from ssd_keras_torch.eval import (
    COCOEvalBBox,
    coco_bbox_iou,
    get_coco_category_maps,
    predict_all_to_json,
)
from ssd_keras_torch.models import ssd300_predictor_sizes

torch.set_num_threads(2)


def _seeded_gt_and_results(seed=0, n_images=12, cats=(1, 5, 9)):
    """A COCO GT dict (areas of every size range, some crowd boxes) and
    detections near it (jittered, duplicated, missed and stray)."""
    rng = np.random.RandomState(seed)
    anns, results = [], []
    for img in range(1, n_images + 1):
        for _ in range(rng.randint(0, 6)):
            size = rng.choice([8, 40, 150]) * (0.7 + rng.rand(2))
            box = [float(v) for v in np.round(np.r_[rng.rand(2) * 300, size], 1)]
            cat = int(rng.choice(cats))
            anns.append({"id": len(anns) + 1, "image_id": img, "category_id": cat, "bbox": box,
                         "iscrowd": int(rng.rand() < 0.1)})
            for _ in range(rng.randint(0, 3)):
                jit = np.array(box) + np.r_[rng.randn(2) * box[2] * 0.15, rng.randn(2) * 3]
                results.append({"image_id": img, "category_id": cat,
                                "bbox": [round(float(v), 1) for v in jit],
                                "score": round(float(rng.rand()), 3)})
        for _ in range(rng.randint(0, 3)):
            results.append({"image_id": img, "category_id": int(rng.choice(cats)),
                            "bbox": [float(v) for v in np.round(rng.rand(4) * 200, 1)],
                            "score": round(float(rng.rand()), 3)})
    gt = {"images": [{"id": i} for i in range(1, n_images + 1)],
          "categories": [{"id": c, "name": f"c{c}"} for c in cats], "annotations": anns}
    return gt, results


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cocoeval_stats_equal_jax(seed, tmp_path):
    gt, results = _seeded_gt_and_results(seed)
    gt_path, res_path = tmp_path / "gt.json", tmp_path / "res.json"
    gt_path.write_text(json.dumps(gt))
    res_path.write_text(json.dumps(results))
    port = COCOEvalBBox(str(gt_path), str(res_path))
    jax = JaxCOCOEvalBBox(str(gt_path), str(res_path))
    m_port, m_jax = port.evaluate(), jax.evaluate()
    assert m_port == m_jax and len(m_port) == 12
    np.testing.assert_array_equal(port.stats, jax.stats)
    assert np.isfinite(port.stats).all() and 0 < m_port["AP50"] < 1
    np.testing.assert_array_equal(_stats(COCOEvalBBox(gt, results, (1, 3, 100))),
                                  _stats(JaxCOCOEvalBBox(gt, results, (1, 3, 100))))
    dt = np.array([r["bbox"] for r in results[:20]])
    gtb = np.array([a["bbox"] for a in gt["annotations"]])
    crowd = [a["iscrowd"] for a in gt["annotations"]]
    np.testing.assert_array_equal(coco_bbox_iou(dt, gtb, crowd), jax_coco_bbox_iou(dt, gtb, crowd))


def _stats(ev):
    ev.evaluate()
    return ev.stats


@pytest.fixture()
def annotations_file(tmp_path):
    ann = {"categories": [{"id": 44, "name": "bottle"}, {"id": 1, "name": "person"},
                          {"id": 18, "name": "dog"}], "images": [], "annotations": []}
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(ann))
    return str(path)


def test_category_maps(annotations_file):
    cats_to_classes, classes_to_cats, cats_to_names, classes_to_names = (
        get_coco_category_maps(annotations_file))
    assert cats_to_classes == {1: 1, 18: 2, 44: 3}
    assert classes_to_cats == {1: 1, 2: 18, 3: 44}
    assert cats_to_names == {1: "person", 18: "dog", 44: "bottle"}
    assert classes_to_names == ["background", "person", "dog", "bottle"]


def _in_memory(cls, images, labels, ids):
    gen = cls(labels=[np.asarray(l, np.float32) for l in labels], image_ids=ids)
    gen.images = list(images)
    gen.dataset_size = len(images)
    gen.dataset_indices = np.arange(len(images), dtype=np.int32)
    return gen


def test_predict_all_to_json_inference_mode_maps_back_to_the_original_frame(
        tmp_path, annotations_file):
    """Boxes in the original image frame (the Resize inverter applied) and
    original category ids; the model sees uint8 tensors on the device."""
    rng = np.random.RandomState(0)
    h0, w0 = 60, 90
    images = [rng.randint(0, 255, (h0, w0, 3), np.uint8) for _ in range(3)]
    gen = _in_memory(DataGenerator, images, [np.array([[1, 2.0, 3.0, 20.0, 30.0]])] * 3,
                     [101, 102, 103])
    classes_to_cats = get_coco_category_maps(annotations_file)[1]

    def fake_model(batch_x):
        assert batch_x.dtype == torch.uint8 and batch_x.shape[1:] == (48, 48, 3)
        out = torch.zeros((batch_x.shape[0], 4, 6))
        out[:, 0] = torch.tensor([2, 0.9, 12.0, 6.0, 36.0, 30.0])
        return out

    results = predict_all_to_json(str(tmp_path / "results.json"), fake_model, 48, 48,
                                  classes_to_cats, gen, batch_size=2, model_mode="inference",
                                  verbose=False, device="cpu")
    assert json.loads((tmp_path / "results.json").read_text()) == results
    assert [r["image_id"] for r in results] == [101, 102, 103]
    for r in results:
        assert r["category_id"] == 18 and r["score"] == 0.9
        x, y, w, h = r["bbox"]
        assert x == pytest.approx(12.0 * w0 / 48, abs=0.51)
        assert y == pytest.approx(6.0 * h0 / 48, abs=0.51)
        assert w == pytest.approx(24.0 * w0 / 48, abs=1.01)
        assert h == pytest.approx(24.0 * h0 / 48, abs=1.01)


@pytest.fixture(scope="module")
def coco_stream():
    """SynthVOC images at 300x300 as a COCO-81 problem, and a noisy stream
    of 'training'-mode predictions from the port's encoder's targets."""
    images, labels = SynthVOC(8, image_size=300, split="val", seed=6).materialize()
    cfg = SSDConfig.ssd300(n_classes=80, dataset="coco")
    enc = SSDInputEncoder(cfg, ssd300_predictor_sizes(300, 300), max_gt_boxes=8, device="cpu")
    y = enc.encode_padded(*pad_labels(labels, 8)).numpy()
    rng = np.random.RandomState(7)
    logits = 6.0 * y[..., :81] + 1.5 * rng.randn(*y.shape[:2], 81)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    y[..., :81] = e / e.sum(-1, keepdims=True)
    y[..., 81:85] += 0.15 * rng.randn(*y.shape[:2], 4)
    return images, labels, y.astype(np.float32)


class _Stream:
    def __init__(self, y, wrap):
        self.y, self.wrap, self.i = y, wrap, 0

    def __call__(self, batch):
        out = self.y[self.i:self.i + len(batch)]
        self.i += len(batch)
        return self.wrap(out)


@pytest.mark.parametrize("model_mode", ["training", "inference"])
def test_predict_all_to_json_equals_jax(coco_stream, tmp_path, model_mode):
    """The same JSON as the JAX package's, in the same order. 'training':
    both decode the same raw stream on the host. 'inference': both get the
    same detections (the port's decode of that stream)."""
    images, labels, y = coco_stream
    if model_mode == "inference":
        from ssd_keras_torch.decoder import decode_detections_fixed

        y = decode_detections_fixed(torch.from_numpy(y), img_height=300, img_width=300).numpy()
    classes_to_cats = {i: 1 + 2 * i for i in range(1, 81)}  # non-consecutive ids
    out = {}
    for kind, gen_cls, fn, wrap, kw in (
            ("port", DataGenerator, predict_all_to_json, torch.from_numpy, dict(device="cpu")),
            ("jax", JaxDataGenerator, jax_predict_all_to_json, np.asarray, {})):
        gen = _in_memory(gen_cls, images, labels, list(range(1, 9)))
        out[kind] = fn(str(tmp_path / f"{kind}.json"), _Stream(y, wrap), 300, 300,
                       classes_to_cats, gen, batch_size=3, model_mode=model_mode, verbose=False,
                       **kw)
    assert len(out["jax"]) > 20
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    gt = {"images": [{"id": i} for i in range(1, 9)],
          "categories": [{"id": c} for c in classes_to_cats.values()],
          "annotations": [{"id": k, "image_id": i + 1, "category_id": classes_to_cats[int(c)],
                           "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]}
                          for i, lab in enumerate(labels) for k, (c, x0, y0, x1, y1)
                          in enumerate(lab, start=100 * i)]}
    stats = COCOEvalBBox(gt, out["port"]).evaluate()
    assert stats == JaxCOCOEvalBBox(gt, out["jax"]).evaluate()
    assert 0 < stats["AP50"] <= 1
