"""Evaluate SSD300 on MS COCO through the results JSON.

Port of the JAX package's ``examples/ssd300_evaluation_coco.py``: the
predictions become a COCO results JSON (``predict_all_to_json``), scored by
pycocotools where it is installed and otherwise by the vendored
``COCOEvalBBox``, which prints ``COCO AP=... AP50=...``.

Usage:
  python -m ssd_keras_torch.examples.ssd300_evaluation_coco \
      --images_dir ./val2017 --annotations ./annotations/instances_val2017.json \
      --weights trained_coco.h5
"""

from __future__ import annotations

import argparse

from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.data import DataGenerator
from ssd_keras_torch.eval import COCOEvalBBox, get_coco_category_maps, predict_all_to_json
from ssd_keras_torch.examples.common import (
    add_device_args,
    add_weight_args,
    device_of,
    dtype_of,
    load_weights,
    print_nms_launches,
)
from ssd_keras_torch.models import ssd_300


def main(argv=None):
    p = argparse.ArgumentParser(description="SSD300 MS-COCO evaluation")
    p.add_argument("--images_dir", required=True)
    p.add_argument("--annotations", required=True)
    add_weight_args(p)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--out_file", default="detections_coco_results.json")
    p.add_argument("--n_classes", type=int, default=80,
                   help="number of foreground classes (80 for MS COCO; match "
                        "the annotations file's category count)")
    p.add_argument("--mode", default="inference", choices=["training", "inference"],
                   help="'inference' decodes on the device (the NMS kernel on the card), "
                        "'training' on the host")
    add_device_args(p)
    args = p.parse_args(argv)

    device = device_of(args)
    model, _ = ssd_300(SSDConfig.ssd300(n_classes=args.n_classes, dataset="coco"),
                       mode=args.mode, compute_dtype=dtype_of(args), device=device)

    dataset = DataGenerator(load_images_into_memory=False, jpeg_device=device)
    dataset.parse_json([args.images_dir], [args.annotations], ground_truth_available=False)
    _, classes_to_cats, _, _ = get_coco_category_maps(args.annotations)
    load_weights(model, args.weights, args.checkpoint)

    predict_all_to_json(
        args.out_file,
        model,
        img_height=300,
        img_width=300,
        classes_to_cats=classes_to_cats,
        data_generator=dataset,
        batch_size=args.batch_size,
        model_mode=args.mode,
        device=device,
    )
    print_nms_launches()

    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError:
        print("pycocotools not installed; scoring with the vendored COCO bbox metric.")
        ev = COCOEvalBBox(args.annotations, args.out_file)
        metrics = ev.evaluate()
        ev.summarize()
        print(f"COCO AP={metrics['AP']:.4f} AP50={metrics['AP50']:.4f}")
        return metrics

    coco_gt = COCO(args.annotations)
    coco_eval = COCOeval(coco_gt, coco_gt.loadRes(args.out_file), "bbox")
    coco_eval.evaluate()
    coco_eval.accumulate()
    coco_eval.summarize()
    return None


if __name__ == "__main__":
    main()
