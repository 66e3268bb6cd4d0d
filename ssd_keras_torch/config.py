"""Typed SSD configuration — the single source of truth.

Vendored unchanged from ``ssd_keras_tpu/config.py`` (NumPy only), so that the
PyTorch port imports without JAX.

The reference has no config system: the model builders (keras_ssd300.py:31),
``SSDInputEncoder`` (ssd_input_encoder.py:36) and the decoders each take wide,
overlapping kwargs that the user must keep in agreement manually (the docstring
at keras_ssd300.py:66-70 warns about exactly this). Here one frozen dataclass
feeds all three, so model / encoder / decoder can never disagree on anchors,
variances, or coordinate conventions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ssd_keras_torch.ops import anchors as anchor_ops

__all__ = ["SSDConfig"]


def _freeze(x):
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    """Everything the model, target encoder, and decoder must agree on.

    ``n_classes`` counts *positive* classes only (20 for Pascal VOC, 80 for
    COCO) — the background class is added internally, mirroring the reference
    convention (keras_ssd300.py:175).
    """

    img_height: int
    img_width: int
    img_channels: int
    n_classes: int  # positive classes, excluding background
    # Anchor geometry
    scales: Tuple[float, ...]
    aspect_ratios: Tuple[Tuple[float, ...], ...]  # one tuple per predictor layer
    two_boxes_for_ar1: bool = True
    steps: Optional[Tuple[float, ...]] = None
    offsets: Optional[Tuple[float, ...]] = None
    clip_boxes: bool = False
    variances: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    coords: str = "centroids"
    normalize_coords: bool = True
    border_pixels: str = "half"
    # Matching / encoding
    matching_type: str = "multi"  # 'multi' | 'bipartite'
    pos_iou_threshold: float = 0.5
    neg_iou_limit: float = 0.3
    background_id: int = 0
    # Input preprocessing (applied inside the model graph, Caffe-style)
    subtract_mean: Optional[Tuple[float, ...]] = None
    divide_by_stddev: Optional[Tuple[float, ...]] = None
    swap_channels: Optional[Tuple[int, ...]] = None
    # Decode defaults (DecodeDetections parity: keras_layer_DecodeDetections.py:38-47)
    confidence_thresh: float = 0.01
    iou_threshold: float = 0.45
    top_k: int = 200
    nms_max_output_size: int = 400

    def __post_init__(self):
        object.__setattr__(self, "scales", _freeze(self.scales))
        object.__setattr__(self, "aspect_ratios", _freeze(self.aspect_ratios))
        for name in ("steps", "offsets", "variances", "subtract_mean", "divide_by_stddev", "swap_channels"):
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(self, name, _freeze(v))
        if len(self.scales) != self.n_predictor_layers + 1:
            raise ValueError(
                f"len(scales) must equal n_predictor_layers+1 = {self.n_predictor_layers + 1}, "
                f"got {len(self.scales)}."
            )
        if any(s <= 0 for s in self.scales):
            raise ValueError(f"All scales must be > 0, got {self.scales}.")
        if len(self.variances) != 4 or any(v <= 0 for v in self.variances):
            raise ValueError(f"4 positive variances required, got {self.variances}.")
        if self.coords not in ("centroids", "corners", "minmax"):
            raise ValueError(f"Unsupported coords {self.coords!r}.")
        if self.matching_type not in ("multi", "bipartite"):
            raise ValueError(f"Unsupported matching_type {self.matching_type!r}.")
        for ars in self.aspect_ratios:
            if any(a <= 0 for a in ars):
                raise ValueError("All aspect ratios must be > 0.")
        if self.steps is not None and len(self.steps) != self.n_predictor_layers:
            raise ValueError("One step per predictor layer required.")
        if self.offsets is not None and len(self.offsets) != self.n_predictor_layers:
            raise ValueError("One offset per predictor layer required.")

    # ------------------------------------------------------------------ #

    @property
    def n_predictor_layers(self) -> int:
        return len(self.aspect_ratios)

    @property
    def n_classes_with_background(self) -> int:
        return self.n_classes + 1

    @property
    def n_boxes_per_cell(self) -> List[int]:
        return [
            anchor_ops.n_boxes_per_cell(ars, self.two_boxes_for_ar1)
            for ars in self.aspect_ratios
        ]

    def total_boxes(self, predictor_sizes: Sequence[Tuple[int, int]]) -> int:
        return int(
            sum(
                h * w * n
                for (h, w), n in zip(predictor_sizes, self.n_boxes_per_cell)
            )
        )

    def anchor_tensor(self, predictor_sizes: Sequence[Tuple[int, int]]) -> np.ndarray:
        """(total_boxes, 8) anchors + variances; see ops.anchors.build_anchor_tensor."""
        return anchor_ops.build_anchor_tensor(
            self.img_height,
            self.img_width,
            predictor_sizes,
            self.aspect_ratios,
            self.scales,
            two_boxes_for_ar1=self.two_boxes_for_ar1,
            steps=self.steps,
            offsets=self.offsets,
            clip_boxes=self.clip_boxes,
            variances=self.variances,
            normalize_coords=self.normalize_coords,
            coords=self.coords,
        )

    # ------------------------- canonical presets ---------------------- #

    @staticmethod
    def from_min_max_scale(
        min_scale: float, max_scale: float, n_predictor_layers: int
    ) -> Tuple[float, ...]:
        return tuple(np.linspace(min_scale, max_scale, n_predictor_layers + 1).tolist())

    @classmethod
    def ssd300(cls, n_classes: int = 20, dataset: str = "voc", **overrides) -> "SSDConfig":
        """Canonical SSD300 config (ssd300_training.ipynb cell 4)."""
        scales = {
            "voc": (0.1, 0.2, 0.37, 0.54, 0.71, 0.88, 1.05),
            "coco": (0.07, 0.15, 0.33, 0.51, 0.69, 0.87, 1.05),
        }[dataset]
        kw = dict(
            img_height=300,
            img_width=300,
            img_channels=3,
            n_classes=n_classes,
            scales=scales,
            aspect_ratios=(
                (1.0, 2.0, 0.5),
                (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                (1.0, 2.0, 0.5),
                (1.0, 2.0, 0.5),
            ),
            steps=(8, 16, 32, 64, 100, 300),
            offsets=(0.5,) * 6,
            subtract_mean=(123.0, 117.0, 104.0),
            swap_channels=(2, 1, 0),
            neg_iou_limit=0.5,
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def ssd512(cls, n_classes: int = 20, dataset: str = "voc", **overrides) -> "SSDConfig":
        """Canonical SSD512 config (ssd512_inference.ipynb cell 5)."""
        scales = {
            "voc": (0.07, 0.15, 0.3, 0.45, 0.6, 0.75, 0.9, 1.05),
            "coco": (0.04, 0.1, 0.26, 0.42, 0.58, 0.74, 0.9, 1.06),
        }[dataset]
        kw = dict(
            img_height=512,
            img_width=512,
            img_channels=3,
            n_classes=n_classes,
            scales=scales,
            aspect_ratios=(
                (1.0, 2.0, 0.5),
                (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                (1.0, 2.0, 0.5),
                (1.0, 2.0, 0.5),
            ),
            steps=(8, 16, 32, 64, 128, 256, 512),
            offsets=(0.5,) * 7,
            subtract_mean=(123.0, 117.0, 104.0),
            swap_channels=(2, 1, 0),
            neg_iou_limit=0.5,
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def ssd7(
        cls,
        n_classes: int = 5,
        img_height: int = 300,
        img_width: int = 480,
        **overrides,
    ) -> "SSDConfig":
        """Canonical SSD7 config (ssd7_training.ipynb cell 4: explicit scales
        [0.08, 0.16, 0.32, 0.64, 0.96], [-1, 1] input scaling, unit variances)."""
        kw = dict(
            img_height=img_height,
            img_width=img_width,
            img_channels=3,
            n_classes=n_classes,
            scales=(0.08, 0.16, 0.32, 0.64, 0.96),
            aspect_ratios=((0.5, 1.0, 2.0),) * 4,
            two_boxes_for_ar1=True,
            variances=(1.0, 1.0, 1.0, 1.0),
            normalize_coords=True,
            subtract_mean=(127.5, 127.5, 127.5),
            divide_by_stddev=(127.5, 127.5, 127.5),
        )
        kw.update(overrides)
        return cls(**kw)
