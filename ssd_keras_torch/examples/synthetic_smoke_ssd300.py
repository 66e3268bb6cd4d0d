"""Smoke: overfit SSD300 on synthetic shapes with the on-device pipeline.

Port of the JAX package's ``examples/synthetic_smoke_ssd300.py``: coloured
rectangles -> ``DeviceSSDAugmentation`` -> on-device encoding -> bf16 SSD300
train steps -> decode on the device (the NMS kernel on the card) ->
recall@0.5 on the training images. It prints ``SMOKE PASS`` when the loss
halves and the recall passes 0.6, the JAX script's criterion, kept as it
is. At 400 steps neither package reaches that recall at the seeds measured
(the port 0.21-0.54 at seeds 0-7 on an H100, the JAX package 0.19-0.53 at
seeds 0-2 on the CPU), so a run prints ``SMOKE WEAK`` with a halved loss.

Usage:  python -m ssd_keras_torch.examples.synthetic_smoke_ssd300 [--steps 400] [--images 16]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ssd_keras_torch import SSDConfig, SSDInputEncoder, SSDLoss
from ssd_keras_torch import train as T
from ssd_keras_torch.data.device_aug import DeviceSSDAugmentation, batch_seed
from ssd_keras_torch.decoder import decode_detections_fixed
from ssd_keras_torch.encoder import pad_labels
from ssd_keras_torch.examples.common import add_device_args, device_of, dtype_of
from ssd_keras_torch.models import ssd_300
from ssd_keras_torch.ops.boxes import iou_np


def make_dataset(n_images, rng, size=300):
    images, labels = [], []
    for _ in range(n_images):
        img = rng.randint(0, 50, (size, size, 3)).astype(np.uint8)
        boxes = []
        for _ in range(rng.randint(1, 4)):
            cls = rng.randint(1, 4)
            w, h = [(90, 90), (60, 140), (150, 70)][cls - 1]
            x1 = rng.randint(0, size - w)
            y1 = rng.randint(0, size - h)
            color = [(240, 60, 60), (60, 240, 60), (60, 60, 240)][cls - 1]
            img[y1:y1 + h, x1:x1 + w] = color
            boxes.append([cls, x1, y1, x1 + w, y1 + h])
        images.append(img)
        labels.append(np.array(boxes, dtype=np.float32))
    return np.stack(images), labels


def recall_at_05(detections, labels):
    """Ground-truth boxes found by a detection of their class at IoU >= 0.5,
    each claimed once (the JAX smoke's count)."""
    tp = total = 0
    for dets, gt in zip(detections, labels):
        total += len(gt)
        claimed = np.zeros(len(gt), bool)
        for det in dets:
            ious = iou_np(gt[:, 1:], det[2:6], coords="corners", mode="element-wise")
            best = int(np.argmax(ious))
            if ious[best] >= 0.5 and gt[best, 0] == det[0] and not claimed[best]:
                claimed[best] = True
                tp += 1
    return tp, total


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="SSD300 overfit smoke on synthetic shapes")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--clipnorm", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    add_device_args(p)
    args = p.parse_args(argv)

    device = device_of(args)
    rng = np.random.RandomState(args.seed)
    config = SSDConfig.ssd300(n_classes=3)
    model, sizes = ssd_300(config, compute_dtype=dtype_of(args), device=device,
                           generator=torch.Generator().manual_seed(args.seed))
    encoder = SSDInputEncoder(config, sizes, max_gt_boxes=16, device=device)
    aug = DeviceSSDAugmentation(300, 300)

    images, labels = make_dataset(args.images, rng)
    padded, counts = pad_labels(labels, encoder.max_gt_boxes)
    images_d = torch.from_numpy(images).to(device)
    padded_d = torch.from_numpy(padded).to(device)
    counts_d = torch.from_numpy(counts).to(device)

    optimizer = T.sgd_with_momentum(model.parameters(), args.lr, momentum=0.9,
                                    clipnorm=args.clipnorm)
    train_step = T.make_train_step(model, optimizer, SSDLoss(), l2_reg=5e-4)

    picker = torch.Generator(device=device).manual_seed(args.seed + 1)
    t0 = time.time()
    first = last = None
    for step in range(args.steps):
        idx = torch.randint(args.images, (args.batch,), generator=picker, device=device)
        imgs, lbls, nn = aug(batch_seed(args.seed + 1, step), images_d[idx], padded_d[idx],
                             counts_d[idx])
        metrics = train_step(imgs, encoder.encode_padded(lbls, nn))
        if step % 50 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            first = loss if first is None else first
            last = loss
            print(f"step {step:4d}  loss {loss:8.4f}  ({time.time() - t0:.0f}s)", flush=True)
    train_s = time.time() - t0

    # Evaluate on the clean (non-augmented) images.
    model.eval()
    with torch.no_grad():
        y_pred = model(images_d)
        dets = decode_detections_fixed(y_pred, confidence_thresh=0.5, img_height=300,
                                       img_width=300).float().cpu().numpy()
    detections = [d[d[:, 1] > 0] for d in dets]
    tp, total = recall_at_05(detections, labels)
    recall = tp / max(1, total)
    print(f"loss {first:.2f} -> {last:.2f}; recall@0.5 on train set: {recall:.2f} "
          f"({tp}/{total})")
    passed = last < first * 0.5 and recall > 0.6
    print("SMOKE PASS" if passed else "SMOKE WEAK -- inspect")
    return dict(passed=passed, first_loss=first, last_loss=last, recall=recall, tp=tp,
                total=total, steps=args.steps, batch=args.batch, train_seconds=train_s,
                img_per_s=args.steps * args.batch / train_s)


if __name__ == "__main__":
    main()
