"""Dataset container, annotation parsers, HDF5 cache, and batch generator.

Capability parity with
data_generator/object_detection_2d_data_generator.py
(``DataGenerator`` :66): in-memory / HDF5 / lazy-file image sources, CSV /
Pascal-VOC-XML / MS-COCO-JSON parsers, HDF5 dataset creation, pickling, and
the infinite ``generate()`` loop with per-epoch shuffling, sequential
transform application (with inverter collection), degenerate-box handling,
and configurable return tuples.

Vendored from ``ssd_keras_tpu/data/datasets.py`` (NumPy only) for the
PyTorch port. Four changes: ``h5py`` and ``PIL`` are imported at their first
use, not with the module, so that the port imports without them;
``parse_xml`` reads the XML with the standard library's ``ElementTree``, not
BeautifulSoup and lxml, which the machines the port is built for lack; the HDF5
cache resizes with ``data.geometric.resize_image`` (OpenCV's arithmetic in
the host C++ of ``native.image_ops``), not OpenCV; and the
batch decode of a lazy batch of JPEG files (``_get_images_batch``) runs on
the generator's ``jpeg_device``: the card by default (nvJPEG), ``"cpu"``
for the JAX package's libjpeg decoder, None for PIL one file at a time.
Where the JAX package falls back to PIL when its decoder is missing or
rejects a file, the port raises. A fifth, private: the evaluator's source
``_generate_on_card``, which keeps a batch of its 'resize' chain on the card
(decode, colour and resize kernels) where the batch allows it.
"""

from __future__ import annotations

import csv
import json
import os
import pickle
import warnings
from copy import deepcopy
from typing import Optional, Sequence

import numpy as np

from ssd_keras_torch import native
from ssd_keras_torch.data.geometric import INTER_LINEAR, Resize, resize_image, routes_to_linear
from ssd_keras_torch.data.validation import BoxFilter
from ssd_keras_torch.utils.profiling import count, span

__all__ = [
    "DataGenerator",
    "DatasetError",
    "DegenerateBatchError",
]


def _h5py(what):
    try:
        import h5py
    except ImportError as e:
        raise DatasetError(f"h5py is required for {what}.") from e
    return h5py


class DatasetError(Exception):
    """Raised when a requested dataset interaction is impossible."""


class DegenerateBatchError(Exception):
    """Raised when a generated batch is empty or inhomogeneous."""


class DataGenerator:
    """2D-detection dataset container and batch generator.

    Ground truth is stored as one ``(k, 5)`` array per image with rows in
    ``labels_output_format`` order (default ``class_id, xmin, ymin, xmax,
    ymax``). ``jpeg_device`` is where a lazy batch of JPEG files is decoded
    (``_get_images_batch``): ``"cuda"`` (the default) or ``"cuda:N"`` on the
    card through nvJPEG, ``"cpu"`` through libjpeg, None one file at a time
    through PIL.
    """

    def __init__(
        self,
        load_images_into_memory: bool = False,
        hdf5_dataset_path: Optional[str] = None,
        filenames=None,
        filenames_type: str = "text",
        images_dir: Optional[str] = None,
        labels=None,
        image_ids=None,
        eval_neutral=None,
        labels_output_format=("class_id", "xmin", "ymin", "xmax", "ymax"),
        verbose: bool = True,
        jpeg_device="cuda",
    ):
        self.jpeg_device = jpeg_device
        self.labels_output_format = tuple(labels_output_format)
        self.labels_format = {name: i for i, name in enumerate(labels_output_format)}

        self.dataset_size = 0
        self.load_images_into_memory = load_images_into_memory
        self.images = None
        self.filenames = None
        self.labels = None
        self.image_ids = None
        self.eval_neutral = None
        self.hdf5_dataset = None
        self.hdf5_dataset_path = hdf5_dataset_path

        if filenames is not None:
            self.filenames = self._load_listlike(filenames, filenames_type, images_dir)
            self.dataset_size = len(self.filenames)
            self.dataset_indices = np.arange(self.dataset_size, dtype=np.int32)
            if load_images_into_memory:
                self.images = [self._read_image(fn) for fn in self.filenames]

        if labels is not None:
            self.labels = self._load_pickled(labels, "labels")
        if image_ids is not None:
            self.image_ids = self._load_pickled(image_ids, "image_ids")
        if eval_neutral is not None:
            self.eval_neutral = self._load_pickled(eval_neutral, "eval_neutral")

        if hdf5_dataset_path is not None:
            self.load_hdf5_dataset(verbose=verbose)

    # ------------------------------ helpers ------------------------------ #

    @staticmethod
    def _load_listlike(value, filenames_type, images_dir):
        if isinstance(value, str):
            if filenames_type == "pickle":
                with open(value, "rb") as f:
                    return pickle.load(f)
            with open(value) as f:
                names = [line.strip() for line in f if line.strip()]
            if images_dir is not None:
                names = [os.path.join(images_dir, n) for n in names]
            return names
        return list(value)

    @staticmethod
    def _load_pickled(value, what):
        if isinstance(value, str):
            with open(value, "rb") as f:
                return pickle.load(f)
        if isinstance(value, (list, tuple)):
            return list(value)
        raise ValueError(f"`{what}` must be a list or a pickle filepath.")

    @staticmethod
    def _read_image(filename) -> np.ndarray:
        try:
            from PIL import Image
        except ImportError as e:
            raise DatasetError("PIL is required to read images from disk.") from e
        with Image.open(filename) as img:
            return np.array(img, dtype=np.uint8)

    def get_dataset_size(self) -> int:
        return self.dataset_size

    def get_dataset(self):
        return self.filenames, self.labels, self.image_ids, self.eval_neutral

    # ------------------------------ parsers ------------------------------ #

    def parse_csv(
        self,
        images_dir: str,
        labels_filename: str,
        input_format: Sequence[str],
        include_classes="all",
        random_sample=False,
        ret=False,
        verbose=True,
    ):
        """Parse a flat CSV of per-box rows (one image may span several rows).

        ``input_format`` names the CSV columns, e.g.
        ``['image_name', 'xmin', 'xmax', 'ymin', 'ymax', 'class_id']``.
        """
        required = {"image_name", "xmin", "ymin", "xmax", "ymax", "class_id"}
        if not required.issubset(set(input_format)):
            raise ValueError(f"`input_format` must contain {sorted(required)}.")
        col = {name: i for i, name in enumerate(input_format)}

        entries = {}
        order = []
        with open(labels_filename, newline="") as f:
            reader = csv.reader(f)
            rows = list(reader)
        # Skip a header row if present (non-numeric coordinate field).
        start = 0
        if rows and not _is_number(rows[0][col["xmin"]]):
            start = 1
        for row in rows[start:]:
            if not row:
                continue
            name = row[col["image_name"]].strip()
            class_id = int(row[col["class_id"]])
            if include_classes != "all" and class_id not in include_classes:
                continue
            # Reorder the CSV columns into labels_output_format.
            out_row = [0] * len(self.labels_output_format)
            for i, field in enumerate(self.labels_output_format):
                out_row[i] = class_id if field == "class_id" else int(
                    round(float(row[col[field]]))
                )
            if name not in entries:
                entries[name] = []
                order.append(name)
            entries[name].append(out_row)

        order.sort()
        if random_sample:
            keep = int(len(order) * random_sample)
            idx = np.random.choice(len(order), keep, replace=False)
            order = [order[i] for i in sorted(idx)]

        self.filenames = [os.path.join(images_dir, n) for n in order]
        self.labels = [np.array(entries[n]) for n in order]
        self.image_ids = [os.path.splitext(n)[0] for n in order]
        self.dataset_size = len(self.filenames)
        self.dataset_indices = np.arange(self.dataset_size, dtype=np.int32)
        if self.load_images_into_memory:
            self.images = [self._read_image(fn) for fn in self.filenames]
        if ret:
            return self.images, self.filenames, self.labels, self.image_ids

    def parse_xml(
        self,
        images_dirs: Sequence[str],
        image_set_filenames: Sequence[str],
        annotations_dirs=(),
        classes=(
            "background", "aeroplane", "bicycle", "bird", "boat", "bottle",
            "bus", "car", "cat", "chair", "cow", "diningtable", "dog",
            "horse", "motorbike", "person", "pottedplant", "sheep", "sofa",
            "train", "tvmonitor",
        ),
        include_classes="all",
        exclude_truncated=False,
        exclude_difficult=False,
        ret=False,
        verbose=True,
    ):
        """Parse Pascal-VOC XML annotations.

        ``difficult`` objects are kept (unless excluded) and recorded in
        ``eval_neutral`` so the evaluator can skip them without penalty.
        The XML is read with the standard library's ``ElementTree``: every
        ``<object>`` in document order, its own ``<name>``, ``<truncated>``,
        ``<difficult>`` and ``<bndbox>`` (not those of its ``<part>``
        sub-boxes), as the JAX package reads it with BeautifulSoup.
        """
        from xml.etree import ElementTree

        classes = list(classes)
        self.filenames, self.labels = [], []
        self.image_ids, self.eval_neutral = [], []
        if not annotations_dirs:
            self.labels = None
            self.eval_neutral = None
            annotations_dirs = [None] * len(images_dirs)

        for images_dir, image_set_filename, annotations_dir in zip(
            images_dirs, image_set_filenames, annotations_dirs
        ):
            with open(image_set_filename) as f:
                image_ids = [line.strip() for line in f if line.strip()]
            for image_id in image_ids:
                self.filenames.append(os.path.join(images_dir, image_id + ".jpg"))
                self.image_ids.append(image_id)
                if annotations_dir is None:
                    continue
                tree = ElementTree.parse(os.path.join(annotations_dir, image_id + ".xml"))
                boxes, neutral = [], []
                for obj in tree.getroot().iter("object"):
                    class_name = obj.find("name").text
                    if class_name not in classes:
                        continue
                    class_id = classes.index(class_name)
                    if include_classes != "all" and class_id not in include_classes:
                        continue
                    truncated = int(_tag_text(obj, "truncated", "0"))
                    difficult = int(_tag_text(obj, "difficult", "0"))
                    if exclude_truncated and truncated:
                        continue
                    if exclude_difficult and difficult:
                        continue
                    bndbox = obj.find("bndbox")
                    coords = {"class_id": class_id}
                    for key in ("xmin", "ymin", "xmax", "ymax"):
                        coords[key] = int(float(next(bndbox.iter(key)).text))
                    boxes.append([coords[k] for k in self.labels_output_format])
                    neutral.append(bool(difficult))
                self.labels.append(np.array(boxes).reshape(-1, 5))
                self.eval_neutral.append(neutral)

        self.dataset_size = len(self.filenames)
        self.dataset_indices = np.arange(self.dataset_size, dtype=np.int32)
        if self.load_images_into_memory:
            self.images = [self._read_image(fn) for fn in self.filenames]
        if ret:
            return (self.images, self.filenames, self.labels,
                    self.image_ids, self.eval_neutral)

    def parse_json(
        self,
        images_dirs: Sequence[str],
        annotations_filenames: Sequence[str],
        ground_truth_available=False,
        include_classes="all",
        ret=False,
        verbose=True,
    ):
        """Parse MS-COCO-format JSON annotations.

        COCO category IDs are non-consecutive; they are remapped to
        consecutive IDs starting at 1 (``self.cats_to_classes`` keeps the
        mapping, as the reference does at :542-665).
        """
        self.filenames, self.image_ids = [], []
        self.labels = [] if ground_truth_available else None

        self.cats_to_names = {}
        self.classes_to_names = []
        self.cats_to_classes = {}
        self.classes_to_cats = {}

        for images_dir, annotations_filename in zip(images_dirs, annotations_filenames):
            with open(annotations_filename) as f:
                coco = json.load(f)

            if not self.cats_to_classes:
                cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
                self.classes_to_names.append("background")
                for i, cat in enumerate(cats, start=1):
                    self.cats_to_names[cat["id"]] = cat["name"]
                    self.classes_to_names.append(cat["name"])
                    self.cats_to_classes[cat["id"]] = i
                    self.classes_to_cats[i] = cat["id"]

            annotations_by_image = {}
            for ann in coco.get("annotations", []):
                annotations_by_image.setdefault(ann["image_id"], []).append(ann)

            for img in coco["images"]:
                self.filenames.append(os.path.join(images_dir, img["file_name"]))
                self.image_ids.append(img["id"])
                if not ground_truth_available:
                    continue
                boxes = []
                for ann in annotations_by_image.get(img["id"], []):
                    class_id = self.cats_to_classes[ann["category_id"]]
                    if include_classes != "all" and class_id not in include_classes:
                        continue
                    x, y, w, h = ann["bbox"]
                    coords = {
                        "class_id": class_id,
                        "xmin": int(round(x)),
                        "ymin": int(round(y)),
                        "xmax": int(round(x + w)),
                        "ymax": int(round(y + h)),
                    }
                    boxes.append([coords[k] for k in self.labels_output_format])
                self.labels.append(np.array(boxes).reshape(-1, 5))

        self.dataset_size = len(self.filenames)
        self.dataset_indices = np.arange(self.dataset_size, dtype=np.int32)
        if self.load_images_into_memory:
            self.images = [self._read_image(fn) for fn in self.filenames]
        if ret:
            return self.images, self.filenames, self.labels, self.image_ids

    # ------------------------------ HDF5 cache --------------------------- #

    def create_hdf5_dataset(
        self, file_path="dataset.h5", resize=False, variable_image_size=True,
        verbose=True,
    ):
        """Serialize the dataset into a single HDF5 file for fast reads.

        Images are stored as flattened variable-length uint8 with a parallel
        shapes dataset; 1/4-channel images are normalized to 3 channels.
        """
        h5py = _h5py("create_hdf5_dataset")
        f = h5py.File(file_path, "w")
        f.attrs.create("dataset_size", self.dataset_size)
        vlen_uint8 = h5py.special_dtype(vlen=np.uint8)
        vlen_float = h5py.special_dtype(vlen=np.float64)
        vlen_str = h5py.special_dtype(vlen=str)

        images_ds = f.create_dataset("images", (self.dataset_size,), dtype=vlen_uint8)
        shapes_ds = f.create_dataset(
            "image_shapes", (self.dataset_size, 3), dtype=np.int32
        )
        labels_ds = labelshape_ds = ids_ds = neutral_ds = None
        if self.labels is not None:
            labels_ds = f.create_dataset("labels", (self.dataset_size,), dtype=vlen_float)
            f.attrs.create(
                "labels_output_format",
                np.array(self.labels_output_format, dtype="S"),
            )
        if self.image_ids is not None:
            ids_ds = f.create_dataset("image_ids", (self.dataset_size,), dtype=vlen_str)
        if self.eval_neutral is not None:
            neutral_ds = f.create_dataset(
                "eval_neutral", (self.dataset_size,), dtype=vlen_uint8
            )

        for i in range(self.dataset_size):
            if self.images is not None:
                image = self.images[i]
            else:
                image = self._read_image(self.filenames[i])
            if image.ndim == 2:
                image = np.stack([image] * 3, axis=-1)
            elif image.shape[2] == 1:
                image = np.concatenate([image] * 3, axis=-1)
            elif image.shape[2] == 4:
                image = image[:, :, :3]
            if resize:
                image = resize_image(image, resize[0], resize[1])
            images_ds[i] = image.reshape(-1)
            shapes_ds[i] = np.asarray(image.shape, dtype=np.int32)
            if labels_ds is not None:
                labels_ds[i] = np.asarray(self.labels[i], dtype=np.float64).reshape(-1)
            if ids_ds is not None:
                ids_ds[i] = str(self.image_ids[i])
            if neutral_ds is not None:
                neutral_ds[i] = np.asarray(self.eval_neutral[i], dtype=np.uint8)
        # Filenames are always stored so lazy loading keeps working.
        fn_ds = f.create_dataset("filenames", (self.dataset_size,), dtype=vlen_str)
        for i, fn in enumerate(self.filenames):
            fn_ds[i] = fn
        f.close()
        self.hdf5_dataset_path = file_path
        self.load_hdf5_dataset(verbose=verbose)

    def load_hdf5_dataset(self, verbose=True):
        h5py = _h5py("load_hdf5_dataset")
        self.hdf5_dataset = h5py.File(self.hdf5_dataset_path, "r")
        self.dataset_size = int(self.hdf5_dataset.attrs["dataset_size"])
        self.dataset_indices = np.arange(self.dataset_size, dtype=np.int32)
        self.filenames = list(self.hdf5_dataset["filenames"].asstr()[:])
        if "labels" in self.hdf5_dataset:
            self.labels = [
                arr.reshape(-1, 5) for arr in self.hdf5_dataset["labels"][:]
            ]
        if "image_ids" in self.hdf5_dataset:
            self.image_ids = list(self.hdf5_dataset["image_ids"].asstr()[:])
        if "eval_neutral" in self.hdf5_dataset:
            self.eval_neutral = [
                list(arr.astype(bool)) for arr in self.hdf5_dataset["eval_neutral"][:]
            ]

    def save_dataset(
        self, filenames_path="filenames.pkl", labels_path=None,
        image_ids_path=None, eval_neutral_path=None,
    ):
        with open(filenames_path, "wb") as f:
            pickle.dump(self.filenames, f)
        if labels_path is not None:
            with open(labels_path, "wb") as f:
                pickle.dump(self.labels, f)
        if image_ids_path is not None:
            with open(image_ids_path, "wb") as f:
                pickle.dump(self.image_ids, f)
        if eval_neutral_path is not None:
            with open(eval_neutral_path, "wb") as f:
                pickle.dump(self.eval_neutral, f)

    # ------------------------------ generator ---------------------------- #

    def _get_image(self, index: int) -> np.ndarray:
        if self.images is not None:
            return np.asarray(self.images[index])
        if self.hdf5_dataset is not None:
            shape = self.hdf5_dataset["image_shapes"][index]
            return self.hdf5_dataset["images"][index].reshape(shape)
        return self._read_image(self.filenames[index])

    def _jpeg_files(self, indices) -> bool:
        """Whether the batch ``indices`` is read lazily from files that are
        all ``.jpg``/``.jpeg``, to be decoded on ``jpeg_device``."""
        return (self.jpeg_device is not None and self.images is None
                and self.hdf5_dataset is None and bool(self.filenames)
                and all(str(self.filenames[i]).lower().endswith((".jpg", ".jpeg"))
                        for i in indices))

    def _read_files(self, indices) -> list:
        buffers = []
        with span("data.read"):
            for i in indices:
                with open(self.filenames[i], "rb") as f:
                    buffers.append(f.read())
        return buffers

    def _get_images_batch(self, indices, buffers=None) -> list:
        """Fetch a batch of images, decoding JPEG files as one batch.

        When reading lazily from disk and every file of the batch is a
        ``.jpg``/``.jpeg``, the whole batch is decoded in one
        ``native.decode_jpeg_batch`` call on ``jpeg_device`` (the card's
        nvJPEG, or ``"cpu"``: libjpeg), which raises if that decoder is
        missing or rejects a file; ``buffers`` are the files' bytes, if
        read already. Non-JPEG files, mixed batches, in-memory and
        HDF5-cached datasets, and ``jpeg_device=None`` use the per-image
        path, PIL for files.
        """
        indices = [int(i) for i in indices]
        if self._jpeg_files(indices):
            if buffers is None:
                buffers = self._read_files(indices)
            with span("data.decode"):
                return native.decode_jpeg_batch(buffers, device=self.jpeg_device)
        with span("data.read"):
            return [self._get_image(i) for i in indices]

    def generate(
        self,
        batch_size=32,
        shuffle=True,
        transformations=(),
        label_encoder=None,
        returns=("processed_images", "encoded_labels"),
        keep_images_without_gt=False,
        degenerate_box_handling="remove",
    ):
        """Infinite batch generator.

        Yields a tuple assembled per ``returns`` from: 'processed_images',
        'encoded_labels', 'matched_anchors', 'processed_labels', 'filenames',
        'image_ids', 'evaluation-neutral', 'inverse_transforms',
        'original_images', 'original_labels'.
        """
        return self._generate(batch_size, shuffle, transformations, label_encoder, returns,
                              keep_images_without_gt, degenerate_box_handling, None)

    def _generate_on_card(self, resize: Resize, batch_size=32, shuffle=True,
                          transformations=(), label_encoder=None,
                          returns=("processed_images", "encoded_labels"),
                          keep_images_without_gt=False, degenerate_box_handling="remove"):
        """:meth:`generate` over a chain that the caller knows to end in
        ``resize`` (a linear ``Resize``) with nothing before it that changes
        a 3-channel image (the evaluator's 'resize' mode:
        ``[ConvertTo3Channels(), resize]``). Where the files are read lazily
        and decoded on a CUDA ``jpeg_device`` and 'original_images' is not
        asked for, each batch of JPEG files that the colour kernel takes
        whole and whose sizes ``resize_image`` would resize with ``_linear``
        (``geometric.routes_to_linear``) stays on the card: nvJPEG, the
        colour kernel and the resize kernel (``kernels/resize.py``) make its
        'processed_images', a (B, h, w, 3) uint8 CUDA tensor equal to the
        host chain's pixels. Labels and inverters come from
        ``resize.labels_and_inverter``, as in the host chain. Every other
        batch takes the host chain, as in :meth:`generate`. Each batch adds
        the images it resized on the card (0 for the host chain) to the
        counter ``data.device_resized``."""
        if resize.interpolation_mode != INTER_LINEAR:
            raise ValueError("the card resizes in INTER_LINEAR only, got interpolation mode "
                             f"{resize.interpolation_mode}")
        return self._generate(batch_size, shuffle, transformations, label_encoder, returns,
                              keep_images_without_gt, degenerate_box_handling, resize)

    def _generate(self, batch_size, shuffle, transformations, label_encoder, returns,
                  keep_images_without_gt, degenerate_box_handling, resize):
        # 'inverse_transform' (reference spelling) and 'inverse_transforms'
        # are accepted interchangeably.
        returns = ["inverse_transforms" if r == "inverse_transform" else r for r in returns]
        canonical = [
            "processed_images", "encoded_labels", "matched_anchors",
            "processed_labels", "filenames", "image_ids", "evaluation-neutral",
            "inverse_transforms", "original_images", "original_labels",
        ]
        # Sets have no reliable ordering: emit in the canonical order then
        # (matching the reference's fixed compose order at
        # object_detection_2d_data_generator.py:1162-1174).
        requested = set(returns)
        unknown = requested - set(canonical)
        if unknown:
            raise ValueError(f"Unknown returns {sorted(unknown)}.")
        returns = [r for r in canonical if r in requested]
        if self.dataset_size == 0:
            raise DatasetError("Cannot generate batches: no dataset loaded.")
        if self.labels is None:
            for r in ("original_labels", "processed_labels", "encoded_labels",
                      "matched_anchors", "evaluation-neutral"):
                if r in returns:
                    warnings.warn(
                        f"'{r}' requested but no labels are present; yielding None."
                    )
        elif label_encoder is None:
            for r in ("encoded_labels", "matched_anchors"):
                if r in returns:
                    warnings.warn(
                        f"'{r}' requested but no label encoder given; yielding None."
                    )

        box_filter = None
        if degenerate_box_handling == "remove":
            box_filter = BoxFilter(
                check_overlap=False, check_min_area=False, check_degenerate=True,
                labels_format=self.labels_format,
            )

        for t in transformations:
            if hasattr(t, "labels_format"):
                t.labels_format = self.labels_format

        counting = resize is not None
        if "original_images" in returns or not self._decodes_on_card():
            resize = None
        assemble = dict(returns=returns, label_encoder=label_encoder, box_filter=box_filter,
                        keep_images_without_gt=keep_images_without_gt,
                        degenerate_box_handling=degenerate_box_handling)

        indices = np.asarray(self.dataset_indices)
        if shuffle:
            indices = np.random.permutation(indices)
        current = 0

        while True:
            if current >= self.dataset_size:
                current = 0
                if shuffle:
                    indices = np.random.permutation(self.dataset_indices)

            batch_indices = indices[current : current + batch_size]
            current += batch_size

            buffers = None
            if resize is not None and self._jpeg_files(batch_indices):
                buffers = self._read_files(batch_indices)
                resized = self._resized_on_card(buffers, resize)
                if resized is not None:
                    count("data.device_resized", len(batch_indices))
                    yield self._assemble(batch_indices, resized[1], transformations,
                                         on_card=(resized[0], resize), **assemble)
                    continue
            if counting:
                count("data.device_resized", 0)
            yield self._assemble(batch_indices, self._get_images_batch(batch_indices, buffers),
                                 transformations, **assemble)

    def _decodes_on_card(self) -> bool:
        """Whether lazy JPEG batches are decoded on a card."""
        if self.jpeg_device is None:
            return False
        import torch

        return torch.device(self.jpeg_device).type == "cuda"

    def _resized_on_card(self, buffers, resize):
        """The batch ``buffers`` decoded and resized on the card to
        ``resize``'s size: (images, sizes), the (B, h, w, 3) uint8 tensor
        and each file's (height, width); None, before anything is decoded,
        where a file would go to PIL or its size would not take the linear
        path."""
        from ssd_keras_torch.kernels import resize as resize_kernel
        from ssd_keras_torch.native import jpeg

        out_h, out_w = resize.out_height, resize.out_width
        with span("data.decode"):
            packed = jpeg.decode_packed(
                buffers, self.jpeg_device,
                accept=lambda h, w: routes_to_linear(h, w, out_h, out_w))
        if packed is None:
            return None
        pixels, layout = packed
        with span("data.resize"):
            images = resize_kernel.resize_linear_u8(pixels, layout, out_h, out_w)
        return images, [tuple(hw) for hw in layout[:, 5:7].tolist()]

    def _assemble(self, batch_indices, batch_images, transformations, returns, label_encoder,
                  box_filter, keep_images_without_gt, degenerate_box_handling, on_card=None):
        """One batch of ``generate``: ``batch_images`` through the chain,
        then collated per ``returns``. ``on_card``, for a batch the card
        resized: (the (B, h, w, 3) tensor, the chain's ``Resize``), with
        ``batch_images`` each source's (height, width); the chain is then
        that ``Resize``'s labels and inverter alone, and the processed
        images are the tensor's rows of the kept items."""
        batch_X, batch_y = [], []
        batch_filenames, batch_image_ids, batch_neutral = [], [], []
        batch_original_images, batch_original_labels = [], []
        batch_inverse_transforms = []

        with span("data.transform"):
            for k, idx in enumerate(batch_indices):
                idx = int(idx)
                image = batch_images[k]
                labels = (
                    deepcopy(self.labels[idx]) if self.labels is not None else None
                )
                batch_filenames.append(
                    self.filenames[idx] if self.filenames is not None else None
                )
                batch_image_ids.append(
                    self.image_ids[idx] if self.image_ids is not None else None
                )
                batch_neutral.append(
                    self.eval_neutral[idx] if self.eval_neutral is not None else None
                )
                if "original_images" in returns:
                    batch_original_images.append(np.copy(image))
                if "original_labels" in returns:
                    batch_original_labels.append(
                        deepcopy(labels) if labels is not None else None
                    )

                if (labels is None or labels.size == 0) and not keep_images_without_gt:
                    batch_X.append(None)
                    batch_y.append(None)
                    batch_inverse_transforms.append(None)
                    continue

                inverters = []
                failed = False
                if on_card is not None:
                    labels, inverter = on_card[1].labels_and_inverter(*image, labels)
                    image, inverters = k, [inverter]
                for transform in transformations if on_card is None else ():
                    wants_inverter = "inverse_transforms" in returns and (
                        "return_inverter"
                        in _call_params(transform)
                    )
                    if labels is None:
                        if wants_inverter:
                            out = transform(image, return_inverter=True)
                            image, inv = out
                            inverters.append(inv)
                        else:
                            image = transform(image)
                        if image is None:
                            failed = True
                            break
                    else:
                        if wants_inverter:
                            out = transform(image, labels, return_inverter=True)
                            if isinstance(out, tuple) and len(out) == 3:
                                image, labels, inv = out
                            else:
                                image, labels = out
                                inv = None
                            if inv is not None:
                                if isinstance(inv, list):
                                    inverters.extend(inv)
                                else:
                                    inverters.append(inv)
                        else:
                            image, labels = transform(image, labels)
                        if image is None:
                            failed = True
                            break

                if failed:
                    batch_X.append(None)
                    batch_y.append(None)
                    batch_inverse_transforms.append(None)
                    continue

                if labels is not None and labels.size > 0:
                    fx = self.labels_format
                    xmin, ymin = fx["xmin"], fx["ymin"]
                    xmax, ymax = fx["xmax"], fx["ymax"]
                    degenerate = np.any(labels[:, xmax] <= labels[:, xmin]) or np.any(
                        labels[:, ymax] <= labels[:, ymin]
                    )
                    if degenerate:
                        if degenerate_box_handling == "warn":
                            warnings.warn(
                                f"Degenerate ground truth boxes in batch item {idx}."
                            )
                        elif box_filter is not None:
                            labels = box_filter(labels)
                    if labels.size == 0 and not keep_images_without_gt:
                        batch_X.append(None)
                        batch_y.append(None)
                        batch_inverse_transforms.append(None)
                        continue

                batch_X.append(image)
                batch_y.append(labels)
                batch_inverse_transforms.append(inverters[::-1])

        with span("data.collate"):
            # Drop failed/filtered items from every parallel list.
            keep = [i for i, x in enumerate(batch_X) if x is not None]

            def select(lst):
                return [lst[i] for i in keep]

            batch_X = select(batch_X)
            batch_y = select(batch_y)
            batch_filenames = select(batch_filenames)
            batch_image_ids = select(batch_image_ids)
            batch_neutral = select(batch_neutral)
            batch_inverse_transforms = select(batch_inverse_transforms)
            if "original_images" in returns:
                batch_original_images = select(batch_original_images)
            if "original_labels" in returns:
                batch_original_labels = select(batch_original_labels)

            if len(batch_X) == 0:
                raise DegenerateBatchError(
                    "The generated batch is empty: all images were filtered out. "
                    "Check your transformation chain and keep_images_without_gt."
                )
            if on_card is not None:
                import torch

                images = on_card[0]
                batch_X_arr = images if len(keep) == len(images) else images[
                    torch.as_tensor(keep, device=images.device)]
            else:
                shapes = {x.shape for x in batch_X}
                if len(shapes) != 1:
                    raise DegenerateBatchError(
                        f"Batch images have inhomogeneous sizes {shapes}; add a "
                        "Resize (or crop/pad) transformation producing a fixed size."
                    )
                batch_X_arr = np.array(batch_X)

            batch_y_encoded = None
            batch_matched = None
            if label_encoder is not None and self.labels is not None:
                wants_matched = "matched_anchors" in returns
                if wants_matched:
                    try:
                        batch_y_encoded, batch_matched = label_encoder(
                            batch_y, diagnostics=True
                        )
                    except TypeError:  # encoder without diagnostics support
                        batch_y_encoded = label_encoder(batch_y)
                else:
                    batch_y_encoded = label_encoder(batch_y)

            ret = []
            for r in returns:
                if r == "processed_images":
                    ret.append(batch_X_arr)
                elif r == "encoded_labels":
                    ret.append(batch_y_encoded)
                elif r == "matched_anchors":
                    ret.append(batch_matched)
                elif r == "processed_labels":
                    ret.append(batch_y)
                elif r == "filenames":
                    ret.append(batch_filenames)
                elif r == "image_ids":
                    ret.append(batch_image_ids)
                elif r == "evaluation-neutral":
                    ret.append(batch_neutral)
                elif r == "inverse_transforms":
                    ret.append(batch_inverse_transforms)
                elif r == "original_images":
                    ret.append(batch_original_images)
                elif r == "original_labels":
                    ret.append(batch_original_labels)
                else:
                    raise ValueError(f"Unknown return {r!r}.")
        return tuple(ret)


def _call_params(transform):
    import inspect

    try:
        return inspect.signature(transform.__call__).parameters
    except (TypeError, ValueError):
        return {}


def _tag_text(obj, tag, default):
    """The text of ``obj``'s child ``tag`` (an ElementTree element), or
    ``default`` when it has none."""
    node = obj.find(tag)
    return node.text if node is not None else default


def _is_number(s) -> bool:
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False
