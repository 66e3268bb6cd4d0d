"""MS COCO evaluation bridge.

Capability parity with eval_utils/coco_utils.py
(``get_coco_category_maps`` :30, ``predict_all_to_json`` :62): convert whole-
dataset predictions into the COCO results JSON that ``pycocotools.COCOeval``
consumes, with the consecutive<->original category-ID remapping.

Port of ``ssd_keras_tpu/eval/coco.py``: each batch is uploaded to ``device``
as the evaluator uploads it; an 'inference'-mode model decodes on the
device (the NMS kernel on the card) and only its detections cross back, a
'training'-mode model's raw predictions are decoded by the host decoder.
"""

from __future__ import annotations

import json
from math import ceil
from typing import Callable

import numpy as np
import torch

from ssd_keras_torch.data.geometric import Resize
from ssd_keras_torch.data.misc import apply_inverse_transforms
from ssd_keras_torch.data.patch_sampling import RandomPadFixedAR
from ssd_keras_torch.data.photometric import ConvertTo3Channels
from ssd_keras_torch.decoder import decode_detections
from ssd_keras_torch.devices import target_device
from ssd_keras_torch.eval.evaluator import HostCopy, upload_batch

__all__ = ["get_coco_category_maps", "predict_all_to_json"]


def get_coco_category_maps(annotations_file):
    """Build the 4 category-ID maps from a COCO annotations JSON.

    Returns ``(cats_to_classes, classes_to_cats, cats_to_names,
    classes_to_names)`` where "classes" are consecutive IDs starting at 1 and
    "cats" are the original (non-consecutive) COCO category IDs.
    """
    with open(annotations_file) as f:
        annotations = json.load(f)
    cats_to_classes = {}
    classes_to_cats = {}
    cats_to_names = {}
    classes_to_names = ["background"]
    for i, cat in enumerate(sorted(annotations["categories"], key=lambda c: c["id"]), 1):
        cats_to_classes[cat["id"]] = i
        classes_to_cats[i] = cat["id"]
        cats_to_names[cat["id"]] = cat["name"]
        classes_to_names.append(cat["name"])
    return cats_to_classes, classes_to_cats, cats_to_names, classes_to_names


def predict_all_to_json(
    out_file: str,
    model: Callable[[torch.Tensor], torch.Tensor],
    img_height: int,
    img_width: int,
    classes_to_cats,
    data_generator,
    batch_size: int,
    data_generator_mode="resize",
    model_mode="training",
    confidence_thresh=0.01,
    iou_threshold=0.45,
    top_k=200,
    pred_coords="centroids",
    normalize_coords=True,
    verbose=True,
    device="cuda",
):
    """Run predictions over a dataset and write a COCO results JSON.

    Each result is ``{image_id, category_id, bbox: [x, y, w, h], score}`` with
    the consecutive class IDs mapped back to original COCO category IDs.
    ``model`` takes each batch as a tensor on ``device`` (the card unless the
    caller asks for the CPU; no card raises).
    """
    device = target_device(device)
    transformations = [ConvertTo3Channels()]
    if data_generator_mode == "pad":
        transformations.append(RandomPadFixedAR(patch_aspect_ratio=img_width / img_height))
    elif data_generator_mode != "resize":
        raise ValueError(
            f"`data_generator_mode` must be 'resize' or 'pad', got {data_generator_mode!r}."
        )
    transformations.append(Resize(height=img_height, width=img_width))

    generator = data_generator.generate(
        batch_size=batch_size,
        shuffle=False,
        transformations=transformations,
        label_encoder=None,
        returns=["processed_images", "image_ids", "inverse_transforms"],
        keep_images_without_gt=True,
    )

    results = []
    n_images = data_generator.get_dataset_size()
    n_batches = int(ceil(n_images / batch_size))
    for _ in range(n_batches):
        batch_X, batch_image_ids, batch_inverse_transforms = next(generator)
        with torch.no_grad():
            y_pred = HostCopy(model(upload_batch(batch_X, device))).numpy()
        if model_mode == "training":
            y_pred = decode_detections(
                y_pred,
                confidence_thresh=confidence_thresh,
                iou_threshold=iou_threshold,
                top_k=top_k,
                input_coords=pred_coords,
                normalize_coords=normalize_coords,
                img_height=img_height,
                img_width=img_width,
            )
        else:
            y_pred = [item[item[:, 0] != 0] for item in y_pred]
        y_pred = apply_inverse_transforms(y_pred, batch_inverse_transforms)

        for k, batch_item in enumerate(y_pred):
            image_id = batch_image_ids[k]
            for box in batch_item:
                xmin, ymin, xmax, ymax = (float(v) for v in box[2:6])
                results.append(
                    {
                        "image_id": int(image_id),
                        "category_id": int(classes_to_cats[int(box[0])]),
                        "bbox": [
                            round(xmin, 1),
                            round(ymin, 1),
                            round(xmax - xmin, 1),
                            round(ymax - ymin, 1),
                        ],
                        "score": round(float(box[1]), 3),
                    }
                )

    with open(out_file, "w") as f:
        json.dump(results, f)
    if verbose:
        print(f"Prediction results saved in '{out_file}' ({len(results)} boxes).")
    return results
