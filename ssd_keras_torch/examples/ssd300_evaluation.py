"""Evaluate SSD300 on Pascal VOC: per-class AP, mAP and the VOC results files.

Port of the JAX package's ``examples/ssd300_evaluation.py``. A 'training'
mode model's predictions are decoded on the card (the NMS kernel), an
'inference' mode model decodes itself.

Usage:
  python -m ssd_keras_torch.examples.ssd300_evaluation --voc_root ./VOCdevkit \
      --weights trained.h5
"""

from __future__ import annotations

import argparse
import os

import torch

from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.data import DataGenerator
from ssd_keras_torch.eval import Evaluator
from ssd_keras_torch.examples.common import (
    VOC_CLASSES,
    add_device_args,
    add_weight_args,
    device_of,
    dtype_of,
    load_weights,
    print_nms_launches,
)
from ssd_keras_torch.models import ssd_300


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description="SSD300 Pascal-VOC evaluation")
    p.add_argument("--voc_root", required=True)
    add_weight_args(p)
    p.add_argument("--year", default="2007")
    p.add_argument("--split", default="test")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--mode", default="inference", choices=["training", "inference"])
    p.add_argument("--ap_mode", default="sample", choices=["sample", "integrate"])
    p.add_argument("--write_results", default=None, help="prefix for VOC txt files")
    add_device_args(p)
    args = p.parse_args(argv)

    device = device_of(args)
    model, _ = ssd_300(SSDConfig.ssd300(n_classes=20), mode=args.mode,
                       compute_dtype=dtype_of(args), device=device)

    base = os.path.join(args.voc_root, f"VOC{args.year}")
    dataset = DataGenerator(load_images_into_memory=False, jpeg_device=device)
    dataset.parse_xml(
        [os.path.join(base, "JPEGImages")],
        [os.path.join(base, "ImageSets", "Main", f"{args.split}.txt")],
        [os.path.join(base, "Annotations")],
        classes=VOC_CLASSES,
    )
    print(f"eval images: {dataset.get_dataset_size()}")
    load_weights(model, args.weights, args.checkpoint)

    # Batches go up as uint8 (the model casts) and are decoded on the card
    # before anything crosses back to the host.
    evaluator = Evaluator(model, n_classes=20, data_generator=dataset,
                          model_mode=args.mode, device=device)
    with torch.no_grad():
        mean_ap, average_precisions = evaluator(
            img_height=300,
            img_width=300,
            batch_size=args.batch_size,
            average_precision_mode=args.ap_mode,
            return_average_precisions=True,
        )
    for i in range(1, 21):
        print(f"{VOC_CLASSES[i]:<16} AP {average_precisions[i]:.4f}")
    print(f"{'mAP':<16} {mean_ap:.4f}")

    if args.write_results:
        evaluator.write_predictions_to_txt(classes=VOC_CLASSES,
                                           out_file_prefix=args.write_results)
    print_nms_launches()
    return float(mean_ap)


if __name__ == "__main__":
    main()
