"""SynthVOC: a deterministic synthetic 20-class detection benchmark.

Vendored from ``ssd_keras_tpu/data/synthvoc.py`` (NumPy only) so that the
PyTorch port imports without JAX; unchanged but for the import paths.

The reference validates its whole training system by one number — SSD300
mAP 0.77 on Pascal VOC07 (/root/reference/README.md:81-87) — but no real
VOC/COCO data ships in this environment. SynthVOC is the strongest available
proxy: a generated Pascal-VOC-shaped benchmark of nontrivial difficulty that
exercises every part of the pipeline the real recipe does:

* **20 foreground classes** defined by *shape x texture* (10 shapes x
  {solid, striped}). Hue/saturation/value are randomized per instance, so
  color never identifies a class — the model must learn geometry/texture,
  and photometric augmentation is meaningful rather than destructive.
* **Multi-scale**: object sizes are log-uniform in [0.08, 0.75] of the
  canvas, matching the anchor-scale range SSD300's 6 predictor layers cover.
* **Occlusion**: objects may overlap (pairwise IoU up to 0.4 at placement,
  later objects occlude earlier ones); ground-truth boxes stay full-extent,
  like VOC annotations of occluded objects.
* **Clutter**: low-frequency background gradients, sensor-ish noise, and
  soft gaussian distractor blobs (soft edges, so the sharp-edged 'square'
  class stays learnable).
* **Deterministic**: image ``i`` of a split is a pure function of
  ``(seed, split, i)`` — datasets need no storage and regenerate bit-exactly
  anywhere, which is what makes committed mAP curves reproducible.

Typical difficulty: random guessing is ~0 mAP; an SSD300 trained with the
canonical recipe reaches high (>0.9) mAP, and *errors are real* — small
objects, heavy occlusion, and near-class confusions (ring vs circle,
plus vs x-cross) dominate, like real detection data.
"""

from __future__ import annotations

import colorsys
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["SynthVOC", "SYNTHVOC_CLASS_NAMES"]

_SHAPES = [
    "circle", "square", "triangle", "diamond", "ring",
    "plus", "xcross", "ushape", "lshape", "dots",
]
_TEXTURES = ["solid", "striped"]

#: class id 1..20 -> name (0 is background, VOC-style)
SYNTHVOC_CLASS_NAMES = ["background"] + [
    f"{shape}_{tex}" for shape in _SHAPES for tex in _TEXTURES
]


def _shape_mask(shape: str, h: int, w: int) -> np.ndarray:
    """Boolean mask of ``shape`` on an (h, w) grid normalized to [-1, 1]."""
    v, u = np.mgrid[0:h, 0:w]
    u = (u + 0.5) / w * 2.0 - 1.0
    v = (v + 0.5) / h * 2.0 - 1.0
    if shape == "circle":
        return u * u + v * v <= 1.0
    if shape == "square":
        return np.ones((h, w), bool)
    if shape == "triangle":  # apex at the top, base at the bottom
        return np.abs(u) <= (1.0 + v) / 2.0
    if shape == "diamond":
        return np.abs(u) + np.abs(v) <= 1.0
    if shape == "ring":
        r2 = u * u + v * v
        return (r2 <= 1.0) & (r2 >= 0.45 * 0.45)
    if shape == "plus":
        return (np.abs(u) <= 0.34) | (np.abs(v) <= 0.34)
    if shape == "xcross":
        return np.abs(np.abs(u) - np.abs(v)) <= 0.3
    if shape == "ushape":  # frame open at the top
        return ~((np.abs(u) <= 0.5) & (v <= 0.1))
    if shape == "lshape":  # bottom bar + left column
        return (v >= 0.1) | (u <= -0.1)
    if shape == "dots":  # 3x3 grid of small discs
        mask = np.zeros((h, w), bool)
        for cu in (-0.62, 0.0, 0.62):
            for cv in (-0.62, 0.0, 0.62):
                mask |= (u - cu) ** 2 + (v - cv) ** 2 <= 0.3 * 0.3
        return mask
    raise ValueError(f"Unknown shape {shape!r}.")


def _corner_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise IoU of one box ``a`` (4,) against boxes ``b`` (n, 4)."""
    ix = np.maximum(
        0.0, np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0])
    )
    iy = np.maximum(
        0.0, np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1])
    )
    inter = ix * iy
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


class SynthVOC:
    """Deterministic synthetic detection dataset.

    Args:
      n_images: split size.
      image_size: square canvas edge in pixels.
      split: 'train' / 'val' / 'test' — independent random streams.
      seed: benchmark seed; (seed, split, index) fully determines an image.
      max_objects: most foreground instances per image.
      max_overlap: placement cap on pairwise GT IoU (occlusion level).
    """

    def __init__(self, n_images: int, image_size: int = 300,
                 split: str = "train", seed: int = 0, max_objects: int = 6,
                 max_overlap: float = 0.4):
        self.n_images = int(n_images)
        self.image_size = int(image_size)
        self.split = split
        self.seed = int(seed)
        self.max_objects = int(max_objects)
        self.max_overlap = float(max_overlap)
        self.class_names = SYNTHVOC_CLASS_NAMES
        self.n_classes = len(SYNTHVOC_CLASS_NAMES) - 1  # foreground count

    # ------------------------------------------------------------------ #

    def _rng(self, index: int) -> np.random.RandomState:
        split_id = {"train": 0, "val": 1, "test": 2}.get(self.split, 3)
        return np.random.RandomState(
            (self.seed * 4 + split_id) * 1_000_003 + index
        )

    def _background(self, rng) -> np.ndarray:
        s = self.image_size
        # Low-frequency gradient between two random dark-ish colors.
        c0 = rng.uniform(10, 90, 3)
        c1 = rng.uniform(10, 90, 3)
        t = np.linspace(0, 1, s)
        axis = rng.randint(2)
        ramp = t[:, None] if axis == 0 else t[None, :]
        img = c0 + (c1 - c0) * ramp[..., None]
        img = np.broadcast_to(img, (s, s, 3)).copy()
        # Soft gaussian distractor blobs (no sharp edges).
        v, u = np.mgrid[0:s, 0:s]
        for _ in range(rng.randint(1, 4)):
            cu, cv = rng.uniform(0, s, 2)
            sig = rng.uniform(0.03, 0.12) * s
            blob = np.exp(-(((u - cu) ** 2 + (v - cv) ** 2) / (2 * sig * sig)))
            color = rng.uniform(0, 120, 3)
            img += blob[..., None] * (color - img) * rng.uniform(0.4, 0.9)
        img += rng.normal(0, 6.0, img.shape)  # sensor noise
        return img

    def _instance_color(self, rng) -> np.ndarray:
        hue = rng.uniform(0.0, 1.0)
        sat = rng.uniform(0.45, 1.0)
        val = rng.uniform(0.55, 1.0)
        return np.asarray(colorsys.hsv_to_rgb(hue, sat, val)) * 255.0

    def render(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Render image ``index`` -> (uint8 (S, S, 3), labels (k, 5)).

        Label rows are ``[class_id, xmin, ymin, xmax, ymax]`` with class ids
        1..20 (0 is background), VOC-corner pixel coordinates.
        """
        rng = self._rng(index)
        s = self.image_size
        img = self._background(rng)

        n_objects = rng.randint(1, self.max_objects + 1)
        labels: List[List[float]] = []
        placed = np.zeros((0, 4))
        for _ in range(n_objects):
            cls = rng.randint(1, self.n_classes + 1)
            shape = _SHAPES[(cls - 1) // 2]
            texture = _TEXTURES[(cls - 1) % 2]
            # Log-uniform scale, mild aspect jitter.
            size = float(np.exp(rng.uniform(np.log(0.08), np.log(0.75)))) * s
            aspect = float(np.exp(rng.uniform(np.log(0.6), np.log(1.6))))
            w = int(np.clip(size * np.sqrt(aspect), 10, s - 2))
            h = int(np.clip(size / np.sqrt(aspect), 10, s - 2))
            # Rejection-sample a position obeying the overlap cap.
            for _ in range(12):
                x0 = rng.randint(0, s - w)
                y0 = rng.randint(0, s - h)
                box = np.array([x0, y0, x0 + w, y0 + h], float)
                if placed.shape[0] == 0 or np.all(
                    _corner_iou(box, placed) <= self.max_overlap
                ):
                    break
            else:
                continue  # crowded image: skip this instance

            mask = _shape_mask(shape, h, w)
            color = self._instance_color(rng)
            patch = np.broadcast_to(color, (h, w, 3)).astype(np.float64).copy()
            if texture == "striped":
                v, u = np.mgrid[0:h, 0:w]
                period = max(4, int(min(h, w) / rng.randint(3, 7)))
                stripes = ((u + v) // (period // 2)) % 2 == 0
                patch[stripes] *= 0.45
            # Per-instance brightness jitter inside the shape.
            patch += rng.normal(0, 5.0, patch.shape)
            region = img[y0 : y0 + h, x0 : x0 + w]
            region[mask] = patch[mask]
            placed = np.concatenate([placed, box[None]], axis=0)
            labels.append([cls, x0, y0, x0 + w, y0 + h])

        img = np.clip(img, 0, 255).astype(np.uint8)
        if not labels:  # extremely unlikely; keep shapes non-degenerate
            labels.append([1, 2, 2, 12, 12])
            img[2:12, 2:12] = 200
        return img, np.asarray(labels, dtype=np.float32)

    # ------------------------------------------------------------------ #

    def materialize(self, verbose: bool = False):
        """Render the whole split -> (uint8 (N, S, S, 3), list of (k, 5))."""
        images = np.empty(
            (self.n_images, self.image_size, self.image_size, 3), np.uint8
        )
        labels = []
        it = range(self.n_images)
        if verbose:
            try:
                from tqdm import tqdm

                it = tqdm(it, desc=f"Rendering SynthVOC[{self.split}]")
            except ImportError:
                pass
        for i in it:
            images[i], lab = self.render(i)
            labels.append(lab)
        return images, labels

    def export_voc(self, root: str, images: Optional[np.ndarray] = None,
                   labels: Optional[list] = None, image_set: str = None,
                   class_names: Optional[list] = None):
        """Write the split to disk in Pascal-VOC layout.

        Produces ``JPEGImages/*.jpg``, ``Annotations/*.xml`` and
        ``ImageSets/Main/<split>.txt`` exactly as the reference's
        ``parse_xml`` expects (object_detection_2d_data_generator.py:404),
        so the real XML-parser + host-pipeline workflows can be exercised
        end-to-end without Pascal VOC itself. ``class_names`` (index 0 =
        background, length n_classes+1) overrides the object names written
        to the XMLs — passing the 20 Pascal-VOC names lets the unmodified
        VOC workflow scripts run against the export. Returns
        ``(images_dir, annotations_dir, image_set_path)``.
        """
        import os
        from xml.sax.saxutils import escape

        from PIL import Image

        if images is None or labels is None:
            images, labels = self.materialize()
        names = class_names or SYNTHVOC_CLASS_NAMES
        image_set = image_set or self.split
        img_dir = os.path.join(root, "JPEGImages")
        ann_dir = os.path.join(root, "Annotations")
        set_dir = os.path.join(root, "ImageSets", "Main")
        for d in (img_dir, ann_dir, set_dir):
            os.makedirs(d, exist_ok=True)
        ids = []
        for i in range(len(images)):
            image_id = f"{self.split}_{i:06d}"
            ids.append(image_id)
            Image.fromarray(images[i]).save(
                os.path.join(img_dir, image_id + ".jpg"), quality=95
            )
            objs = []
            for cls, x0, y0, x1, y1 in np.asarray(labels[i]):
                name = escape(names[int(cls)])
                # VOC convention: 1-based inclusive pixel coordinates.
                objs.append(
                    "  <object>\n"
                    f"    <name>{name}</name>\n"
                    "    <pose>Unspecified</pose>\n"
                    "    <truncated>0</truncated>\n"
                    "    <difficult>0</difficult>\n"
                    "    <bndbox>\n"
                    f"      <xmin>{int(x0) + 1}</xmin>\n"
                    f"      <ymin>{int(y0) + 1}</ymin>\n"
                    f"      <xmax>{int(x1)}</xmax>\n"
                    f"      <ymax>{int(y1)}</ymax>\n"
                    "    </bndbox>\n"
                    "  </object>\n"
                )
            s = self.image_size
            xml = (
                "<annotation>\n"
                "  <folder>SynthVOC</folder>\n"
                f"  <filename>{image_id}.jpg</filename>\n"
                f"  <size>\n    <width>{s}</width>\n    <height>{s}</height>\n"
                "    <depth>3</depth>\n  </size>\n"
                "  <segmented>0</segmented>\n" + "".join(objs) + "</annotation>\n"
            )
            with open(os.path.join(ann_dir, image_id + ".xml"), "w") as f:
                f.write(xml)
        set_path = os.path.join(set_dir, image_set + ".txt")
        with open(set_path, "w") as f:
            f.write("\n".join(ids) + "\n")
        return img_dir, ann_dir, set_path

    def export_coco(self, root: str, images: Optional[np.ndarray] = None,
                    labels: Optional[list] = None):
        """Write the split as an MS-COCO annotation JSON + image files.

        Layout matches what the reference's ``parse_json`` consumes
        (object_detection_2d_data_generator.py:542): an ``images`` dir and an
        ``annotations.json`` with images/annotations/categories. Category ids
        are deliberately non-consecutive (10x the class id) to exercise the
        remap path. Returns ``(images_dir, annotations_json_path)``.
        """
        import json
        import os

        from PIL import Image

        if images is None or labels is None:
            images, labels = self.materialize()
        img_dir = os.path.join(root, "images")
        os.makedirs(img_dir, exist_ok=True)
        coco = {
            "images": [], "annotations": [],
            "categories": [
                {"id": cid * 10, "name": SYNTHVOC_CLASS_NAMES[cid]}
                for cid in range(1, self.n_classes + 1)
            ],
        }
        ann_id = 1
        for i in range(len(images)):
            fname = f"{self.split}_{i:06d}.jpg"
            Image.fromarray(images[i]).save(os.path.join(img_dir, fname),
                                            quality=95)
            coco["images"].append({
                "id": i + 1, "file_name": fname,
                "width": self.image_size, "height": self.image_size,
            })
            for cls, x0, y0, x1, y1 in np.asarray(labels[i]):
                coco["annotations"].append({
                    "id": ann_id, "image_id": i + 1,
                    "category_id": int(cls) * 10,
                    "bbox": [float(x0), float(y0),
                             float(x1 - x0), float(y1 - y0)],
                    "area": float((x1 - x0) * (y1 - y0)),
                    "iscrowd": 0,
                })
                ann_id += 1
        ann_path = os.path.join(root, "annotations.json")
        with open(ann_path, "w") as f:
            json.dump(coco, f)
        return img_dir, ann_path

    def as_data_generator(self, images: Optional[np.ndarray] = None,
                          labels: Optional[list] = None):
        """An in-memory :class:`DataGenerator` over this split (for the
        Evaluator and the host augmentation pipeline)."""
        from ssd_keras_torch.data.datasets import DataGenerator

        if images is None or labels is None:
            images, labels = self.materialize()
        gen = DataGenerator(load_images_into_memory=False)
        gen.images = [images[i] for i in range(len(images))]
        gen.labels = [np.asarray(l) for l in labels]
        gen.image_ids = list(range(len(images)))
        gen.eval_neutral = None
        gen.dataset_size = len(images)
        gen.dataset_indices = np.arange(len(images), dtype=np.int32)
        return gen
