"""The one generator of the benchmark's inputs: request schedules, images
and labelled JPEG test sets, all from a cell's parameters and the run's
seed.

Every seed gives the same amount of work: the same multiset of request
sizes and of gaps between arrivals (the gaps are the quantiles of the
exponential distribution at the cell's rate), in another order, and test
sets of the same size and orientations. The seed picks the order, the
pixels and the labels.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class Request(NamedTuple):
    due: float  # seconds after the window opens
    shape: int  # index into the cell's shapes
    images: tuple  # indices into that shape's image pool


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def open_loop(params: dict, seed: int, seconds: float) -> List[Request]:
    """Poisson arrivals at ``rate_per_s`` over ``seconds``; each request
    ``k`` images of one shape, (k, shape) cycling through every pair, then
    shuffled; images drawn from the shape's pool."""
    r = rng(seed, 1)
    rate = float(params["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    due = np.cumsum(r.permutation(gaps))
    lo, hi = params["images_per_request"]
    pairs = [(k, s) for k in range(lo, hi + 1) for s in range(len(params["shapes"]))]
    sizes = [pairs[i % len(pairs)] for i in range(n)]
    order = r.permutation(n)
    pool = params["pool_per_shape"]
    return [Request(float(due[i]), sizes[j][1],
                    tuple(int(x) for x in r.integers(0, pool, sizes[j][0])))
            for i, j in enumerate(order)]


def random_boxes(r: np.random.Generator, n: int, height: int, width: int,
                 area=(0.01, 0.5), aspect=(0.5, 2.0)) -> np.ndarray:
    """``n`` boxes (x1, y1, x2, y2), integer pixels, log-uniform in area
    share and aspect ratio, inside the image."""
    a = np.exp(r.uniform(np.log(area[0]), np.log(area[1]), n)) * height * width
    ar = np.exp(r.uniform(np.log(aspect[0]), np.log(aspect[1]), n))
    w = np.clip(np.sqrt(a * ar), 8, width - 1)
    h = np.clip(np.sqrt(a / ar), 8, height - 1)
    x1 = r.uniform(0, width - w)
    y1 = r.uniform(0, height - h)
    return np.round(np.stack([x1, y1, x1 + w, y1 + h], 1)).astype(np.int64)


def render(boxes: List[np.ndarray], height: int, width: int, seed: int,
           device) -> torch.Tensor:
    """uint8 (n, height, width, 3) images on ``device``: a smooth colour
    field, and over it one shape of a flat colour with a soft texture in
    each box (a rectangle or an ellipse)."""
    n = len(boxes)
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    coarse = torch.rand((n, 3, height // 40 + 2, width // 40 + 2), generator=gen,
                        device=device) * 255
    img = F.interpolate(coarse, size=(height, width), mode="bicubic", align_corners=False)
    fine = torch.rand((n, 1, height // 4, width // 4), generator=gen, device=device) * 24 - 12
    img = img + F.interpolate(fine, size=(height, width), mode="bilinear", align_corners=False)
    colours = torch.rand((sum(len(b) for b in boxes), 3), generator=gen, device=device) * 255
    kinds = torch.rand(len(colours), generator=gen, device=device).tolist()
    ys = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    k = 0
    for i, bs in enumerate(boxes):
        for x1, y1, x2, y2 in bs.tolist():
            if kinds[k] < 0.5:
                mask = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
            else:
                cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
                mask = ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1
            img[i] = torch.where(mask, colours[k][:, None, None] + 0.3 * (img[i] - 128), img[i])
            k += 1
    return img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def image_pool(params: dict, seed: int, device) -> List[np.ndarray]:
    """For each of the cell's shapes, ``pool_per_shape`` images, uint8 on
    the host, (n, height, width, 3)."""
    r = rng(seed, 2)
    pools = []
    for s, (h, w) in enumerate(params["shapes"]):
        boxes = [random_boxes(r, int(r.integers(1, 5)), h, w)
                 for _ in range(params["pool_per_shape"])]
        pools.append(render(boxes, h, w, seed * 31 + s, device).cpu().numpy())
    return pools


class TestSet(NamedTuple):
    files: List[str]
    sizes: List[tuple]  # (height, width)
    labels: List[np.ndarray]  # (k, 5): class, x1, y1, x2, y2
    difficult: List[np.ndarray]  # (k,) bool
    image_ids: List[str]


def jpeg_test_set(params: dict, seed: int, directory: str, device) -> TestSet:
    """``images`` labelled JPEG files in ``directory``: the shapes in the
    cell's proportions (in a seeded order), 1 + Poisson(``extra_objects``)
    objects an image (at most ``max_objects``), classes uniform over
    1..``n_classes``, each "difficult" with probability ``difficult``;
    written by PIL at ``quality`` with ``subsampling`` (2: 4:2:0)."""
    from PIL import Image

    r = rng(seed, 3)
    n = params["images"]
    shapes = []
    for (h, w), share in zip(params["shapes"], params["shares"]):
        shapes += [(h, w)] * int(round(share * n))
    shapes = [shapes[i] for i in r.permutation(len(shapes))][:n]
    files, labels, difficult = [], [], []
    chunk = 64
    for start in range(0, n, chunk):
        part = shapes[start:start + chunk]
        groups = {}
        for i, hw in enumerate(part):
            groups.setdefault(hw, []).append(start + i)
        for (h, w), idxs in groups.items():
            boxes = []
            for _ in idxs:
                k = min(1 + int(r.poisson(params["extra_objects"])), params["max_objects"])
                boxes.append(random_boxes(r, k, h, w))
            pixels = render(boxes, h, w, seed * 7919 + idxs[0], device).cpu().numpy()
            for j, i in enumerate(idxs):
                k = len(boxes[j])
                cls = r.integers(1, params["n_classes"] + 1, k)
                labels.append((i, np.concatenate([cls[:, None], boxes[j]], 1)))
                difficult.append((i, r.random(k) < params["difficult"]))
                path = os.path.join(directory, f"{i:06d}.jpg")
                Image.fromarray(pixels[j]).save(path, quality=params["quality"],
                                                subsampling=params["subsampling"])
                files.append((i, path))
    files = [p for _, p in sorted(files)]
    labels = [lab for _, lab in sorted(labels, key=lambda t: t[0])]
    difficult = [d for _, d in sorted(difficult, key=lambda t: t[0])]
    return TestSet(files, shapes, labels, difficult, [f"{i:06d}" for i in range(n)])


def training_split(params: dict, seed: int, device):
    """A resident training split on ``device``: ``images`` uint8 images of
    ``shape`` (a smooth field with a shape in each box), their labels padded
    to ``max_gt`` rows (B, max_gt, 5) float32 and the counts (B,) int32;
    1 + Poisson(``extra_objects``) boxes an image, classes uniform."""
    r = rng(seed, 5)
    h, w = params["shape"]
    n, m = params["images"], params["max_gt"]
    boxes = [random_boxes(r, min(1 + int(r.poisson(params["extra_objects"])), m), h, w)
             for _ in range(n)]
    padded = np.zeros((n, m, 5), np.float32)
    for i, bs in enumerate(boxes):
        padded[i, :len(bs), 0] = r.integers(1, params["n_classes"] + 1, len(bs))
        padded[i, :len(bs), 1:] = bs
    chunk = 64
    images = torch.cat([render(boxes[i:i + chunk], h, w, seed * 104729 + i, device)
                        for i in range(0, n, chunk)])
    counts = torch.tensor([len(bs) for bs in boxes], dtype=torch.int32, device=device)
    return images, torch.from_numpy(padded).to(device), counts


def balanced_sample(r: np.random.Generator, n_total: int, n: int, longest: List[int]) -> List[int]:
    """``n`` indices of ``range(n_total)`` drawn by ``r``, a third of them
    (at least one) from ``longest``."""
    chosen = [longest[i] for i in r.permutation(len(longest))][: max(1, n // 3)]
    taken = set(chosen)
    rest = [i for i in r.permutation(n_total).tolist() if i not in taken]
    return sorted(chosen + rest[: max(0, n - len(chosen))])
