"""Evaluator decode-path agreement on crowded scenes, with a trained SSD300.

Port of the JAX package's ``examples/evaluator_decode_agreement.py``. The
mAP evaluator runs twice over a crowded SynthVOC split (up to 12 objects an
image, overlap up to 0.5): once with the fixed-shape decode on the device
(``device_decode=True``: the top-k, the candidate pool and the NMS kernel
on the card) and once with the host decoder (``device_decode=False``: NMS
over every candidate, in NumPy). Crowded scenes at decoding confidence 0.01
are where the device decode's static candidate pool could part from the
host's NMS over all candidates, so agreement here says the fast default
costs no mAP. Reports both mAPs, the largest per-class AP delta and the
evaluator's throughput on each path, and prints ``AGREEMENT OK`` when
|delta mAP| < 0.005 and every class's |delta AP| < 0.02.

Usage (after ``synthvoc_benchmark --model ssd300`` has written checkpoints):
  python -m ssd_keras_torch.examples.evaluator_decode_agreement --ckpt DIR \\
      --images 300 --out agreement.md
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ssd_keras_torch import SSDConfig
from ssd_keras_torch.data.synthvoc import SynthVOC
from ssd_keras_torch.eval.evaluator import Evaluator
from ssd_keras_torch.examples.common import add_device_args, device_of, dtype_of, load_weights
from ssd_keras_torch.models import ssd_300

# The JAX script's agreement rule.
MAP_DELTA_MAX = 0.005
CLASS_AP_DELTA_MAX = 0.02


def agreement(dev: dict, host: dict, images: int, compact: int, eligible_stats: dict):
    """The record and the verdict from the two runs' ``mAP``, ``aps`` and
    ``img_per_s``, as the JAX script computes them."""
    delta = abs(dev["mAP"] - host["mAP"])
    per_class = np.abs(np.asarray(dev["aps"]) - np.asarray(host["aps"]))[1:]
    record = {
        "images": images,
        "compact_pool": compact,
        **eligible_stats,
        "mAP_device_decode": round(dev["mAP"], 4),
        "mAP_host_decode": round(host["mAP"], 4),
        "abs_delta": round(delta, 5),
        "max_per_class_ap_delta": round(float(per_class.max()), 5),
        "device_img_per_s": round(dev["img_per_s"], 1),
        "host_img_per_s": round(host["img_per_s"], 1),
    }
    ok = delta < MAP_DELTA_MAX and per_class.max() < CLASS_AP_DELTA_MAX
    return record, bool(ok)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="device vs host decode in the evaluator")
    p.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "synthvoc_ckpt"),
                   help="a ckpt_N.pt checkpoint, or a directory of them: the newest is used")
    p.add_argument("--images", type=int, default=300)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--compact", type=int, default=0,
                   help="cross-class compaction pool for the device decode "
                        "(decoder compact_pool); 0 = off")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "evaluator_decode_agreement.md"))
    add_device_args(p)
    args = p.parse_args(argv)

    device = device_of(args)
    n_classes = 20
    cfg = SSDConfig.ssd300(n_classes=n_classes)
    model, _ = ssd_300(cfg, compute_dtype=dtype_of(args), device=device)
    path = load_weights(model, checkpoint=args.ckpt)
    print(f"restored {os.path.basename(path)}")
    model.eval()

    # Crowded held-out split: up to 12 objects an image, heavier overlap.
    ds = SynthVOC(args.images, 300, split="test", seed=0, max_objects=12, max_overlap=0.5)
    images, labels = ds.materialize(verbose=True)
    gen = ds.as_data_generator(images, labels)

    # How many boxes of an image have any class above the decode's 0.01
    # threshold: the compaction pool is exact while this is <= the pool.
    counts = []
    with torch.no_grad():
        for i in range(0, min(len(images), 128), args.batch):
            y = model(torch.from_numpy(images[i:i + args.batch]).to(device))
            counts.append((y[..., 1:-12].max(-1).values > 0.01).sum(-1).cpu().numpy())
    counts = np.concatenate(counts)
    eligible_stats = {
        "eligible_boxes_mean": round(float(counts.mean()), 1),
        "eligible_boxes_p99": round(float(np.percentile(counts, 99)), 1),
        "eligible_boxes_max": int(counts.max()),
    }
    print("eligible-box stats:", eligible_stats, flush=True)

    results = {}
    for device_decode in (True, False):
        ev = Evaluator(model, n_classes, gen, model_mode="training", device=device)
        # Pass 1 warms the path (library handles, the host C++ build, the
        # allocator); pass 2 is timed.
        for verbose in (False, True):
            t0 = time.time()
            ev.predict_on_dataset(
                img_height=300, img_width=300, batch_size=args.batch,
                device_decode=device_decode, verbose=verbose,
                decoding_compact_pool=args.compact,
            )
        predict_seconds = time.time() - t0
        ev.get_num_gt_per_class(ignore_neutral_boxes=True, verbose=False)
        ev.match_predictions(ignore_neutral_boxes=True, matching_iou_threshold=0.5,
                             verbose=False)
        ev.compute_precision_recall()
        ev.compute_average_precisions(mode="sample")
        mean_ap = ev.compute_mean_average_precision()
        results[device_decode] = {
            "mAP": float(mean_ap),
            "aps": [float(a) for a in ev.average_precisions],
            "seconds": predict_seconds,
            "img_per_s": args.images / predict_seconds,
        }
        print(f"device_decode={device_decode}: mAP {mean_ap:.4f} "
              f"({predict_seconds:.1f}s, {args.images / predict_seconds:.1f} img/s)")

    record, ok = agreement(results[True], results[False], args.images, args.compact,
                           eligible_stats)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("# Evaluator decode-path agreement (crowded SynthVOC)\n\n")
        f.write("Device fixed-shape decode vs host reference-parity decode, "
                "trained SSD300, crowded scenes (<=12 objs/img, overlap 0.5), "
                "decoding conf 0.01 / NMS 0.45 / top_k 200.\n\n")
        f.write(f"Device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}"
                f"; weights: {os.path.basename(path)}.\n\n")
        f.write("```json\n" + json.dumps(record, indent=2) + "\n```\n")
    print("RESULT " + json.dumps(record))
    print("AGREEMENT OK" if ok else "AGREEMENT DIVERGED — inspect")
    return dict(record=record, ok=ok, results=results, out=args.out, checkpoint=path)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
