"""Whole evaluation passes through ``Evaluator.__call__``.

Set-up: the seeded weights, the port's 'inference' model, a labelled JPEG
test set written into the run's temporary directory
(``traffic.jpeg_test_set``), the port's ``DataGenerator`` over the files
(decoded on ``jpeg_device``) and its ``Evaluator``; one pass over the
first ``warmup_images`` files warms every shape. Window: passes over the
whole set back to back, until one ends after ``--seconds``;
``eval_img_per_s`` is the images scored over the window's time. A traced
run profiles its ``trace_pass``-th pass.

Check: once the window has closed, the last pass's detections of a sample
of images drawn from the seed are judged against the plain reference
(PIL's decode of the same files, OpenCV's linear resize, the float32
forward and decode, the rescale to the image's frame) by
``reference.compare.gaps``, and the last pass's mAP against the
reference's mAP of the same detections (``reference.voc``).
"""

from __future__ import annotations

import gc
import tempfile
import time

import numpy as np
import torch

from perfbench import harness, port, traffic, weights
from perfbench.counts import roofline
from perfbench.reference import compare, decode, ssd, voc

SCORE_STAGES = ("get_num_gt_per_class", "match_predictions", "compute_precision_recall",
                "compute_average_precisions", "compute_mean_average_precision")


def _timed(run, name, fn):
    def call(*args, **kwargs):
        with run.span(name):
            return fn(*args, **kwargs)
    return call


def evaluator(run, model, data, n, jpeg_device):
    from ssd_keras_torch.data.datasets import DataGenerator
    from ssd_keras_torch.eval.evaluator import Evaluator

    gen = DataGenerator(filenames=data.files[:n], labels=data.labels[:n],
                        image_ids=data.image_ids[:n],
                        eval_neutral=[list(d) for d in data.difficult[:n]],
                        jpeg_device=jpeg_device, verbose=False)
    ev = Evaluator(model, run.config["n_classes"], gen, model_mode="inference",
                   device=run.device)
    ev.predict_on_dataset = _timed(run, "predict", ev.predict_on_dataset)
    for stage in SCORE_STAGES:
        setattr(ev, stage, _timed(run, "score", getattr(ev, stage)))
    return ev


def per_image(results, image_ids):
    """The evaluator's per-class results as per-image rows [class, score,
    x1, y1, x2, y2]."""
    rows = {i: [] for i in image_ids}
    for c, preds in enumerate(results):
        for image_id, conf, x1, y1, x2, y2 in preds:
            rows[image_id].append((c, conf, x1, y1, x2, y2))
    return {i: np.asarray(r, np.float32).reshape(-1, 6) for i, r in rows.items()}


def reference_pass(run, params, data, indices, served=None, quantize=None):
    """The reference (computed in ``quantize``, if given) over ``indices`` in
    batches of the cell's size: the worst gaps against ``served`` (per image
    id), the NMS work of each batch (``counts.roofline.nms_bound``), and the
    reference's own detections in each image's frame (per image id)."""
    from PIL import Image

    config, device = run.config, run.device
    h, w = config["img_height"], config["img_width"]
    anchors = torch.from_numpy(ssd.anchors(config)).float().to(device)
    worst = dict(served_gap=0.0, missed_gap=0.0)
    nms_s, own = 0.0, {}
    size = run.cell["batch_size"]
    for start in range(0, len(indices), size):
        part = indices[start:start + size]
        pixels = []
        for i in part:
            with Image.open(data.files[i]) as img:
                pixels.append(ssd.resize_linear_uint8(np.asarray(img.convert("RGB")), h, w))
        x = torch.from_numpy(np.stack(pixels)).to(device)
        with torch.no_grad():
            scores, offsets = ssd.forward(config, params, x, quantize=quantize)
            corners = ssd.decode_boxes(config, offsets, anchors)
            out = decode.decode(scores, corners, config["confidence_thresh"],
                                config["iou_threshold"], config["top_k"],
                                config["nms_max_output_size"])
        lanes = roofline.nms_bound(out["valid"].cpu().numpy(), out["keep"].cpu().numpy())
        nms_s += lanes["seconds"]
        for j, i in enumerate(part):
            ih, iw = data.sizes[i]
            scale = torch.tensor([iw / w, ih / h, iw / w, ih / h], device=device)
            real = out["detections"][j, :, 0] != 0
            r = out["detections"][j][real].clone()
            r[:, 2:6] *= scale
            own[data.image_ids[i]] = r.cpu().numpy()
            if served is None:
                continue
            d = torch.from_numpy(served[data.image_ids[i]]).to(device)
            s, m = compare.gaps(d, scores[j], corners[j] * scale, r, out["margin"][j][real])
            worst["served_gap"] = max(worst["served_gap"], s)
            worst["missed_gap"] = max(worst["missed_gap"], m)
    return worst, nms_s, own


def sample(seed: int, n: int, k: int):
    return sorted(traffic.rng(seed, 4).permutation(n)[:k].tolist())


def run(run: harness.Run) -> None:
    cell, config, p = run.cell, run.config, run.cell["traffic"]
    device = run.device
    params = weights.seeded(config, run.seed, device)
    model = port.model(config, "inference", params, device)
    tmp = tempfile.TemporaryDirectory(prefix="perfbench-")
    try:
        data = traffic.jpeg_test_set(p, run.seed, tmp.name, device)
        n = len(data.files)
        call = dict(img_height=config["img_height"], img_width=config["img_width"],
                    batch_size=cell["batch_size"], **cell["evaluate"])
        evaluator(run, model, data, p["warmup_images"], cell["jpeg_device"])(**call)
        ev = evaluator(run, model, data, n, cell["jpeg_device"])
        run.warm_profiler()
        harness.synchronize(device)
        run.spans.clear()
        run.setup_done()

        passes, t0 = 0, time.perf_counter()
        while True:
            prof = run.profiler() if passes == p["trace_pass"] else None
            with run.span("pass"):
                mean_ap = ev(**call)
            if prof is not None:
                run.stop_profiler(prof)
            passes += 1
            if time.perf_counter() - t0 >= run.seconds and (not run.trace or run.traced):
                break
        window = time.perf_counter() - t0
        run.attempted = passes * n
        run.e2e["eval_img_per_s"] = passes * n / window
        # The rate of the passes the profiler did not slow, for the readers.
        traced = [b - a for a, b in run.spans["pass"]][p["trace_pass"]] if run.traced else 0.0
        run.values.update(window_s=window - traced, images=(passes - bool(traced)) * n,
                          scored=passes * n,
                          jpeg_color_bound_s=sum(
                              roofline.jpeg_color_seconds(roofline.jpeg_color_bytes(h, w))
                              for h, w in data.sizes))

        if device.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
        served = per_image(ev.prediction_results, data.image_ids)
        results = ev.prediction_results
        del ev, model
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ssd.exact_float32()
        checked = sample(run.seed, n, cell["check"]["images"])
        worst = reference_pass(run, params, data, checked, served)[0]
        if run.traced is not None:
            run.values["nms_bound_s"] = reference_pass(run, params, data, list(range(n)))[1]
        worst["map_gap"] = abs(mean_ap - voc.mean_average_precision(
            results, data.labels, data.difficult, data.image_ids, config["n_classes"],
            **cell["check"]["voc"]))
        for name, limit in cell["check"]["limits"].items():
            run.check(name, worst[name], limit)
    finally:
        tmp.cleanup()


def control(run: harness.Run, quantize) -> dict:
    """The check's gaps with the reference computed in ``quantize`` in the
    program's place, on the images a run of this seed would sample."""
    config, p = run.config, run.cell["traffic"]
    params = weights.seeded(config, run.seed, run.device)
    ssd.exact_float32()
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        data = traffic.jpeg_test_set(p, run.seed, tmp, run.device)
        checked = sample(run.seed, len(data.files), run.cell["check"]["images"])
        served = reference_pass(run, params, data, checked, quantize=quantize)[2]
        return reference_pass(run, params, data, checked, served)[0]
