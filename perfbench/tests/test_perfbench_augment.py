"""The reference's augmentation (``reference/augment.py``, batched tensor
arithmetic) against an independent plain version, image by image and
pixel by pixel in float64: the Caffe-SSD photometric chain through Python's
``colorsys``, the expand, the first valid crop candidate, the flip, a
bilinear resample of the view with the mean colour outside the image, and
the boxes by the centre-point rule. Only the draws are shared: both sides
take them from the reference's seed scheme (``draw_photometric`` then
``draw_geometry`` on one generator seeded per batch)."""

import colorsys
import math

import numpy as np
import pytest
import torch

from perfbench.reference import augment

H, W, OUT = 12, 16, 10
B, M = 6, 4


def photometric_plain(image: np.ndarray, d, b: int) -> np.ndarray:
    x = image.astype(np.float64)
    if d.brightness_gate[b]:
        x = x + float(d.brightness_delta[b])
    x = np.clip(x, 0, 255)

    def contrast(v):
        return np.clip(127.5 + float(d.contrast_factor[b]) * (v - 127.5), 0, 255)

    if d.contrast_first[b] and d.contrast_gate[b]:
        x = contrast(x)
    out = np.empty_like(x)
    for i in range(x.shape[0]):
        for j in range(x.shape[1]):
            h, s, v = colorsys.rgb_to_hsv(*x[i, j])
            h, s = h * 180.0, s * 255.0
            if d.saturation_gate[b]:
                s = min(max(s * float(d.saturation_factor[b]), 0.0), 255.0)
            if d.hue_gate[b]:
                h = math.fmod(h + float(d.hue_delta[b]) + 360.0, 180.0)
            out[i, j] = colorsys.hsv_to_rgb(h / 180.0, s / 255.0, v)
    if not d.contrast_first[b] and d.contrast_gate[b]:
        out = contrast(out)
    return np.clip(out, 0, 255)


def iou(a, b) -> float:
    """IoU of (x0, y0, x1, y1) boxes."""
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def view_plain(g, boxes: np.ndarray, n: int, b: int):
    """The rectangle (y0, x0, y1, x1) the output shows, in the image's
    pixels: the expanded canvas, then the first crop candidate of sane
    aspect whose IoU with some box beats its bound."""
    if g.expand[b]:
        r = float(g.expand_ratio[b])
        eh, ew = H * r, W * r
        y0 = -float(g.expand_offset[b, 0]) * (eh - H)
        x0 = -float(g.expand_offset[b, 1]) * (ew - W)
        view = (y0, x0, y0 + eh, x0 + ew)
    else:
        view = (0.0, 0.0, float(H), float(W))
    if not g.crop_attempt[b]:
        return view
    vh, vw = view[2] - view[0], view[3] - view[1]
    for k in range(g.bound_index.shape[1]):
        ph, pw = float(g.crop_scale[b, k, 0]) * vh, float(g.crop_scale[b, k, 1]) * vw
        if not 0.5 <= pw / ph <= 2.0:
            continue
        py0 = view[0] + float(g.crop_position[b, k, 0]) * (vh - ph)
        px0 = view[1] + float(g.crop_position[b, k, 1]) * (vw - pw)
        bound = augment.IOU_BOUNDS[int(g.bound_index[b, k])]
        if any(iou((px0, py0, px0 + pw, py0 + ph), boxes[m]) > bound for m in range(n)):
            return (py0, px0, py0 + ph, px0 + pw)
    return view


def taps(sample: float, size: int):
    """Bilinear taps of a sample position along an axis of ``size``
    pixels; None where the sample lies outside the image."""
    if sample < -0.5 or sample > size - 0.5:
        return None
    s = min(max(sample, 0.0), size - 1.0)
    i0 = int(math.floor(s))
    f = s - i0
    return [(i0, 1.0 - f), (min(i0 + 1, size - 1), f)]


def resample_plain(image: np.ndarray, rect, flip: bool) -> np.ndarray:
    y0, x0, y1, x1 = rect
    sy, sx = OUT / (y1 - y0), OUT / (x1 - x0)
    out = np.empty((OUT, OUT, 3))
    for oy in range(OUT):
        ty = taps((oy + 0.5) / sy + y0 - 0.5, H)
        for ox in range(OUT):
            col = OUT - 1 - ox if flip else ox
            tx = taps((col + 0.5) / sx + x0 - 0.5, W)
            if ty is None or tx is None:
                out[oy, ox] = augment.BACKGROUND
            else:
                out[oy, ox] = sum(wy * wx * image[i, j] for i, wy in ty for j, wx in tx)
    return np.clip(out, 0, 255)


def boxes_plain(labels: np.ndarray, n: int, rect, flip: bool):
    y0, x0, y1, x1 = rect
    sy, sx = OUT / (y1 - y0), OUT / (x1 - x0)
    kept = []
    for c, bx0, by0, bx1, by1 in labels[:n]:
        a, bb = (bx0 - x0) * sx, (bx1 - x0) * sx
        top, bottom = (by0 - y0) * sy, (by1 - y0) * sy
        if flip:
            a, bb = OUT - bb, OUT - a
        cx, cy = (a + bb) / 2, (top + bottom) / 2
        if not (0 <= cx <= OUT - 1 and 0 <= cy <= OUT - 1):
            continue
        a, bb = min(max(a, 0), OUT - 1), min(max(bb, 0), OUT - 1)
        top, bottom = min(max(top, 0), OUT - 1), min(max(bottom, 0), OUT - 1)
        if bb > a and bottom > top:
            kept.append((c, a, top, bb, bottom))
    out = np.zeros((len(labels), 5))
    if kept:
        out[: len(kept)] = kept
    return out, len(kept)


def batch(seed: int):
    r = np.random.default_rng(seed)
    images = torch.from_numpy(r.integers(0, 256, (B, H, W, 3), dtype=np.uint8))
    counts = torch.from_numpy(r.integers(1, M + 1, B).astype(np.int32))
    labels = np.zeros((B, M, 5), np.float32)
    for b in range(B):
        for m in range(int(counts[b])):
            x0, y0 = r.uniform(0, W - 4), r.uniform(0, H - 4)
            labels[b, m] = (r.integers(1, 21), x0, y0, r.uniform(x0 + 2, W), r.uniform(y0 + 2, H))
    return images, torch.from_numpy(labels), counts


SEEDS = range(3000000201, 3000000209)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_reference_augmentation_equals_a_plain_per_image_version(seed):
    images, labels, counts = batch(seed)
    out, new_labels, new_counts = augment.augment(seed, images, labels, counts, OUT, OUT)
    gen = torch.Generator().manual_seed(seed)
    pd, gd = augment.draw_photometric(gen, B), augment.draw_geometry(gen, B)
    for b in range(B):
        n = int(counts[b])
        lab = labels[b].numpy().astype(np.float64)
        rect = view_plain(gd, lab[:, 1:5], n, b)
        flip = bool(gd.flip[b])
        pixels = resample_plain(photometric_plain(images[b].numpy(), pd, b), rect, flip)
        np.testing.assert_allclose(out[b].numpy(), pixels, atol=0.02)
        want, k = boxes_plain(lab, n, rect, flip)
        assert int(new_counts[b]) == k
        np.testing.assert_allclose(new_labels[b].numpy(), want, atol=1e-3)


def test_the_seeds_cover_every_branch():
    seen = dict(expand=0, crop=0, flip=0, keep=0, contrast_first=0, contrast_last=0)
    for seed in SEEDS:
        gen = torch.Generator().manual_seed(seed)
        pd, gd = augment.draw_photometric(gen, B), augment.draw_geometry(gen, B)
        images, labels, counts = batch(seed)
        for b in range(B):
            view = view_plain(gd, labels[b, :, 1:5].numpy().astype(np.float64), int(counts[b]), b)
            full = (0.0, 0.0, float(H), float(W))
            seen["expand"] += bool(gd.expand[b])
            seen["crop"] += bool(gd.crop_attempt[b]) and view != full and not gd.expand[b]
            seen["keep"] += view == full
            seen["flip"] += bool(gd.flip[b])
            seen["contrast_first"] += bool(pd.contrast_first[b] & pd.contrast_gate[b])
            seen["contrast_last"] += bool(~pd.contrast_first[b] & pd.contrast_gate[b])
    assert all(seen.values()), seen
