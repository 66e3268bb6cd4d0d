"""The plain reference against ``ssd_keras_torch`` on the CPU, float32, on
the benchmark's seeded weights: anchors, forward, decode with NMS, and the
VOC mAP of a set of detections."""

import numpy as np
import pytest
import torch

from perfbench import harness, port, traffic, weights
from perfbench.reference import compare, decode, ssd, voc

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["ssd300_voc", "ssd512_voc"])
def net(request):
    config = harness.load_json("configs", request.param)
    params = weights.seeded(config, 5, torch.device("cpu"))
    x = torch.rand((2, config["img_height"], config["img_width"], 3),
                   generator=torch.Generator().manual_seed(1)) * 255
    return config, params, x


def test_forward_and_anchors_equal_the_port_in_float32(net):
    config, params, x = net
    model = port.model(dict(config, compute_dtype="float32"), "training", params, "cpu")
    with torch.no_grad():
        y = model(x)
        scores, offsets = ssd.forward(config, params, x)
    c = config["n_classes"] + 1
    assert torch.allclose(y[..., :c], scores, atol=1e-5)
    assert torch.allclose(y[..., c:c + 4], offsets, atol=1e-5)
    assert torch.equal(y[0, :, c + 4:], torch.from_numpy(ssd.anchors(config)).float())


def test_decode_equals_the_port_in_float32(net):
    config, params, x = net
    model = port.model(dict(config, compute_dtype="float32"), "inference", params, "cpu")
    anchors = torch.from_numpy(ssd.anchors(config)).float()
    with torch.no_grad():
        got = model(x)
        scores, offsets = ssd.forward(config, params, x)
        out = decode.decode(scores, ssd.decode_boxes(config, offsets, anchors),
                            config["confidence_thresh"], config["iou_threshold"],
                            config["top_k"], config["nms_max_output_size"])
    real = out["detections"][..., 0] != 0
    assert real.any() and (out["margin"][real] >= 0).all()
    corners = ssd.decode_boxes(config, offsets, anchors)
    for j in range(len(x)):  # equal up to the order of near ties
        mine = got[j][got[j, :, 0] != 0]
        assert len(mine) == int(real[j].sum())
        gaps = compare.gaps(mine, scores[j], corners[j], out["detections"][j][real[j]],
                            out["margin"][j][real[j]])
        assert max(gaps) < 1e-4


def test_gaps_are_zero_on_the_references_own_detections(net):
    config, params, x = net
    anchors = torch.from_numpy(ssd.anchors(config)).float()
    with torch.no_grad():
        scores, offsets = ssd.forward(config, params, x)
        corners = ssd.decode_boxes(config, offsets, anchors)
        out = decode.decode(scores, corners, config["confidence_thresh"],
                            config["iou_threshold"], config["top_k"],
                            config["nms_max_output_size"])
    real = out["detections"][0, :, 0] != 0
    dets = out["detections"][0][real]
    assert compare.gaps(dets, scores[0], corners[0], dets, out["margin"][0][real]) == (0.0, 0.0)
    moved = dets.clone()
    moved[:, 2:6] += 200.0  # every box far from where the reference puts it
    served, missed = compare.gaps(moved, scores[0], corners[0], dets, out["margin"][0][real])
    assert served > 0.3 and missed > 0.0


def test_voc_map_equals_the_evaluators():
    from ssd_keras_torch.data.datasets import DataGenerator
    from ssd_keras_torch.eval.evaluator import Evaluator

    r = np.random.default_rng(0)
    labels = [np.concatenate([r.integers(1, 4, (k, 1)), traffic.random_boxes(r, k, 100, 120)], 1)
              for k in r.integers(0, 4, 30)]
    difficult = [r.random(len(lab)) < 0.2 for lab in labels]
    ids = [f"{i:03d}" for i in range(30)]
    results = [[] for _ in range(4)]
    for i, lab in enumerate(labels):
        for row in lab:
            for _ in range(2):
                box = row[1:5] + r.normal(0, 6, 4)
                results[int(row[0]) if r.random() < 0.8 else 1].append(
                    (ids[i], float(np.float32(r.random())), *[round(float(v), 1) for v in box]))
    gen = DataGenerator(labels=labels, image_ids=ids, eval_neutral=[list(d) for d in difficult],
                        verbose=False)
    gen.dataset_size = 30
    ev = Evaluator(lambda x: x, 3, gen, device="cpu")
    ev.prediction_results = results
    ev.get_num_gt_per_class(verbose=False)
    ev.match_predictions(verbose=False)
    ev.compute_precision_recall()
    ev.compute_average_precisions()
    want = ev.compute_mean_average_precision()
    assert 0.05 < want < 1
    assert voc.mean_average_precision(results, labels, difficult, ids, 3) == want


def test_quantized_forward_is_further_from_float32_than_bfloat16(net):
    config, params, x = net
    with torch.no_grad():
        ref, _ = ssd.forward(config, params, x)
        low, _ = ssd.forward(config, params, x, quantize=torch.float8_e4m3fn)
    model = port.model(config, "training", params, "cpu")  # bf16, as served
    with torch.no_grad():
        bf16 = model(x)[..., :config["n_classes"] + 1]
    assert (low - ref).abs().max() > 3 * (bf16 - ref).abs().max()
