"""Detection visualization (the notebooks' matplotlib drawing, as a utility).

Port of ``ssd_keras_tpu/utils/visualization.py``: the reference draws
predictions inside its inference and evaluation notebooks; this module draws
them with PIL, imported when :func:`draw_detections` is called (not with the
module), so that the port imports without PIL.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["draw_detections", "DEFAULT_PALETTE"]

DEFAULT_PALETTE = [
    (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 190), (0, 128, 128), (230, 190, 255),
    (170, 110, 40), (255, 250, 200), (128, 0, 0), (170, 255, 195),
    (128, 128, 0), (255, 215, 180), (0, 0, 128), (128, 128, 128),
]


def draw_detections(
    image: np.ndarray,
    detections: np.ndarray,
    class_names: Optional[Sequence[str]] = None,
    confidence_thresh: float = 0.5,
    palette=DEFAULT_PALETTE,
) -> np.ndarray:
    """Draw ``[class_id, conf, xmin, ymin, xmax, ymax]`` rows onto an image.

    Zero-padded rows (class 0 / conf 0) and rows below ``confidence_thresh``
    are skipped. Returns a new uint8 RGB array.
    """
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.asarray(image, dtype=np.uint8)).convert("RGB")
    draw = ImageDraw.Draw(img)
    for det in np.asarray(detections):
        class_id, conf = int(det[0]), float(det[1])
        if class_id == 0 or conf < confidence_thresh:
            continue
        color = palette[(class_id - 1) % len(palette)]
        x1, y1, x2, y2 = (float(v) for v in det[2:6])
        draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        name = (
            class_names[class_id]
            if class_names and class_id < len(class_names)
            else str(class_id)
        )
        label = f"{name} {conf:.2f}"
        tw = draw.textlength(label)
        draw.rectangle([x1, max(0, y1 - 12), x1 + tw + 4, y1], fill=color)
        draw.text((x1 + 2, max(0, y1 - 12)), label, fill=(255, 255, 255))
    return np.asarray(img)
