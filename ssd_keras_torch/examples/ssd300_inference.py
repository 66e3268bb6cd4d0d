"""Run SSD300 inference on images and print the detections.

Port of the JAX package's ``examples/ssd300_inference.py``: build the
'inference'-mode model (decode, per-class NMS on the card, top-k), load
weights, predict, and print the boxes above a display threshold in the
original images' coordinates.

Usage:
  python -m ssd_keras_torch.examples.ssd300_inference --weights trained.h5 image1.jpg
  python -m ssd_keras_torch.examples.ssd300_inference --checkpoint ckpt_dir image1.jpg
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.examples.common import (
    VOC_CLASSES,
    add_device_args,
    add_weight_args,
    device_of,
    dtype_of,
    load_weights,
    print_nms_launches,
    read_images,
)
from ssd_keras_torch.models import ssd_300, ssd_512

ARCHS = {"ssd300": (ssd_300, SSDConfig.ssd300, 300), "ssd512": (ssd_512, SSDConfig.ssd512, 512)}


def run(argv=None, arch: str = "ssd300") -> np.ndarray:
    """The inference workflow of ``arch`` (SSD300 or SSD512); returns the
    (B, top_k, 6) detections in the model's input frame."""
    build, make_config, size = ARCHS[arch]
    p = argparse.ArgumentParser(description=f"{arch.upper()} inference on image files")
    p.add_argument("images", nargs="+")
    add_weight_args(p)
    p.add_argument("--n_classes", type=int, default=20)
    p.add_argument("--dataset", default="voc", choices=["voc", "coco"])
    p.add_argument("--confidence", type=float, default=0.5, help="display threshold")
    p.add_argument("--mode", default="inference", choices=["inference", "inference_fast"])
    add_device_args(p)
    args = p.parse_args(argv)

    device = device_of(args)
    config = make_config(n_classes=args.n_classes, dataset=args.dataset)
    model, _ = build(config, mode=args.mode, compute_dtype=dtype_of(args), device=device)
    load_weights(model, args.weights, args.checkpoint)

    # Load + resize inputs; remember the original sizes to scale boxes back.
    batch, orig_sizes = read_images(args.images, (size, size))
    with torch.no_grad():
        detections = model(torch.from_numpy(batch).to(device)).float().cpu().numpy()

    for i, path in enumerate(args.images):
        w, h = orig_sizes[i]
        sx, sy = w / float(size), h / float(size)
        print(f"\n{path}:")
        print("   class      conf    xmin    ymin    xmax    ymax")
        for det in detections[i]:
            class_id, conf = int(det[0]), float(det[1])
            if class_id == 0 or conf < args.confidence:
                continue
            name = VOC_CLASSES[class_id] if class_id < len(VOC_CLASSES) else str(class_id)
            print(f"   {name:<10} {conf:.3f} "
                  f"{det[2] * sx:7.1f} {det[3] * sy:7.1f} "
                  f"{det[4] * sx:7.1f} {det[5] * sy:7.1f}")
    print_nms_launches()
    return detections


def main(argv=None):
    return run(argv, "ssd300")


if __name__ == "__main__":
    main()
