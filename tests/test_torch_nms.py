"""The port's greedy NMS against the JAX package's.

The plain PyTorch version (``ssd_keras_torch/ops/nms.py``) must give keep
masks *bit-equal* to the Pallas kernel run in interpret mode (at the small
shapes ``tests/test_decoder.py`` uses for it) and to the vmapped scan
``greedy_nms_mask`` at the main-path shape. The wrapper
(``ssd_keras_torch/kernels/nms.py``) takes the plain version for CPU
tensors and launches nothing. On a CUDA tensor the kernel must equal the
plain version bit for bit: that test is in ``tests/test_torch_cuda.py``,
which the card's machine (no JAX there) can run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import make_hard
from ssd_keras_tpu.kernels.nms_pallas import greedy_nms_mask_batched as jax_pallas_nms
from ssd_keras_tpu.ops.nms import greedy_nms_mask as jax_scan_nms
from ssd_keras_torch.kernels import nms as nms_kernel
from ssd_keras_torch.ops.nms import (
    greedy_keep_from_mask, greedy_nms_mask, iou_suppression_mask, mask_words, words_read)
from ssd_keras_torch.utils import profiling

torch.set_num_threads(2)


def _random_lanes(seed, lanes, k, integer=False, prefix=True, spread=50.0, size=30.0):
    """(L, K, 4) corner boxes and an (L, K) valid mask, as numpy."""
    rng = np.random.RandomState(seed)
    boxes = rng.rand(lanes, k, 4).astype(np.float32) * spread
    boxes[..., 2:] = boxes[..., :2] + rng.rand(lanes, k, 2).astype(np.float32) * size + 1
    if integer:
        boxes = np.floor(boxes)
    if prefix:
        scores = -np.sort(-rng.rand(lanes, k).astype(np.float32))
        valid = scores > 0.3
    else:
        valid = rng.rand(lanes, k) > 0.6
    return boxes, valid


def _jax_scan(boxes, valid, thr, d=0.0):
    return np.asarray(
        jax.vmap(lambda b, v: jax_scan_nms(b, v, thr, d))(jnp.asarray(boxes), jnp.asarray(valid))
    )


def _port(boxes, valid, thr, d=0.0):
    return greedy_nms_mask(torch.from_numpy(boxes), torch.from_numpy(valid), thr, d).numpy()


# The interpret-mode cases of tests/test_decoder.py:315-428: a prefix mask,
# integer boxes with border_delta 0/+1/-1, a non-prefix mask with empty
# lanes, and 300 lanes (two of the kernel's 256-lane blocks).
_INTERPRET_CASES = [
    (0, 5, 37, False, True, 0.0),
    (2, 6, 33, True, True, 0.0),
    (2, 6, 33, True, True, 1.0),
    (2, 6, 33, True, True, -1.0),
    (7, 9, 41, False, False, 0.0),
    (1, 300, 40, False, True, 0.0),
]


@pytest.mark.parametrize("seed, lanes, k, integer, prefix, d", _INTERPRET_CASES)
def test_plain_nms_equals_pallas_interpret(seed, lanes, k, integer, prefix, d):
    boxes, valid = _random_lanes(seed, lanes, k, integer=integer, prefix=prefix)
    if not prefix:
        valid[3] = False  # an empty lane
        valid[5] = False
        valid[5, k - 1] = True  # a single valid candidate in the last row
    expected = np.asarray(
        jax_pallas_nms(jnp.asarray(boxes), jnp.asarray(valid), 0.5, d, interpret=True)
    )
    np.testing.assert_array_equal(_port(boxes, valid, 0.5, d), expected)


@pytest.mark.parametrize("prefix", [True, False])
def test_plain_nms_equals_scan_at_main_path_shape(prefix):
    """L = 160, K = 400: VOC SSD300 at batch 8. Boxes cluster so that
    suppression chains are long; the threshold is the decoder's 0.45."""
    boxes, valid = _random_lanes(3, 160, 400, prefix=prefix, spread=200.0, size=60.0)
    valid[7] = False
    expected = _jax_scan(boxes, valid, 0.45)
    got = _port(boxes, valid, 0.45)
    assert expected.any() and (expected != valid).any()  # some kept, some suppressed
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("d", [0.0, 1.0, -1.0])
def test_plain_nms_border_delta_at_main_path_shape(d):
    boxes, valid = _random_lanes(4, 160, 400, integer=True, spread=200.0, size=60.0)
    np.testing.assert_array_equal(_port(boxes, valid, 0.45, d), _jax_scan(boxes, valid, 0.45, d))


def test_plain_nms_degenerate_boxes():
    """Zero-area and inverted boxes hit the ``union > 0`` guard."""
    boxes, valid = _random_lanes(5, 4, 50)
    boxes[:, ::7, 2:] = boxes[:, ::7, :2]  # zero area
    boxes[:, 3::11, 2:] = boxes[:, 3::11, :2] - 5  # inverted
    np.testing.assert_array_equal(_port(boxes, valid, 0.45), _jax_scan(boxes, valid, 0.45))


def test_wrapper_takes_plain_version_on_cpu():
    boxes, valid = _random_lanes(6, 20, 64)
    before = profiling.counters().get("nms.launches", 0)
    got = nms_kernel.greedy_nms_mask_batched(
        torch.from_numpy(boxes), torch.from_numpy(valid), 0.45
    )
    assert profiling.counters().get("nms.launches", 0) == before
    np.testing.assert_array_equal(got.numpy(), _port(boxes, valid, 0.45))


@pytest.mark.parametrize(
    "boxes, valid, error",
    [
        (torch.zeros(2, 5, 4, dtype=torch.float64), torch.zeros(2, 5, dtype=torch.bool), TypeError),
        (torch.zeros(2, 5, 4), torch.zeros(2, 5, dtype=torch.uint8), TypeError),
        (torch.zeros(2, 5, 3), torch.zeros(2, 5, dtype=torch.bool), ValueError),
        (torch.zeros(2, 5, 4), torch.zeros(2, 4, dtype=torch.bool), ValueError),
        (torch.zeros(5, 2, 4).transpose(0, 1), torch.zeros(2, 5, dtype=torch.bool), ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(boxes, valid, error):
    with pytest.raises(error):
        nms_kernel.greedy_nms_mask_batched(boxes, valid, 0.45)


def test_empty_inputs():
    keep = greedy_nms_mask(torch.zeros(3, 0, 4), torch.zeros(3, 0, dtype=torch.bool), 0.45)
    assert keep.shape == (3, 0)
    keep = greedy_nms_mask(torch.zeros(3, 6, 4), torch.zeros(3, 6, dtype=torch.bool), 0.45)
    assert not keep.any()
    for k in (0, 6):
        boxes, valid = torch.zeros(3, k, 4), torch.zeros(3, k, dtype=torch.bool)
        mask = iou_suppression_mask(boxes, valid, 0.45)
        assert mask.shape == (3, k, mask_words(k)) and not mask.any()
        assert not greedy_keep_from_mask(mask, valid).any()


def test_iou_mask_takes_only_cuda_tensors():
    boxes, valid = _random_lanes(6, 2, 8)
    with pytest.raises(ValueError, match="device"):
        nms_kernel.iou_mask(torch.from_numpy(boxes), torch.from_numpy(valid))


# The kernel's two passes in plain PyTorch (ops/nms.py), in the kernel's
# layout: (L, K, ceil(K / 64)) int64 words, bit j % 64 of word j // 64.


def _numpy_suppression(boxes, valid, thr, d):
    """(L, K, K) bool: IoU(i, j) > thr for i < j < bound, in numpy f32 with
    the contract's op order (row i as "a")."""
    d = np.float32(d)
    x1, y1, x2, y2 = np.moveaxis(boxes, -1, 0)
    area = (x2 - x1 + d) * (y2 - y1 + d)
    a, b = (slice(None), slice(None), None), (slice(None), None)  # rows i, columns j
    iw = np.maximum(np.minimum(x2[a], x2[b]) - np.maximum(x1[a], x1[b]) + d, 0)
    ih = np.maximum(np.minimum(y2[a], y2[b]) - np.maximum(y1[a], y1[b]) + d, 0)
    inter = iw * ih
    union = area[a] + area[b] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = np.where(union > 0, inter / union, np.float32(0))
    k = valid.shape[1]
    bound = np.where(valid, np.arange(1, k + 1), 0).max(1) if k else np.zeros(len(valid), int)
    i, j = np.arange(k)[:, None], np.arange(k)[None]
    return (iou > np.float32(thr)) & (i < j) & (j < bound[:, None, None])


@pytest.mark.parametrize(
    "k, prefix, d, hard",
    [(1, True, 0.0, False), (63, False, 1.0, False), (64, True, -1.0, False),
     (65, False, 0.0, True), (400, True, 0.0, True), (400, False, 1.0, False)],
)
def test_suppression_mask_layout(k, prefix, d, hard):
    """Bit j % 64 of word j // 64 in row i is set exactly for i < j < bound
    with IoU > thr; every other bit (bit 63 the sign bit, the last word's
    bits past K, the words below the diagonal and past the bound) is 0."""
    boxes, valid = _random_lanes(20 + k, 5, k, prefix=prefix)
    if hard:
        make_hard(boxes, valid)
    mask = iou_suppression_mask(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45, d)
    assert mask.dtype == torch.int64 and mask.shape == (5, k, mask_words(k))
    bits = (mask.numpy()[..., None] >> np.arange(64)) & 1
    expected = np.zeros((5, k, mask_words(k) * 64), bool)
    expected[..., :k] = _numpy_suppression(boxes, valid, 0.45, d)
    np.testing.assert_array_equal(bits.reshape(expected.shape).astype(bool), expected)
    assert expected.any() or k == 1
    assert not mask[~words_read(torch.from_numpy(valid))].any()


_TWO_PASS_CASES = [
    # (seed, lanes, k, integer, prefix, d, hard): the interpret cases above,
    *[(seed, lanes, k, integer, prefix, d, False)
      for seed, lanes, k, integer, prefix, d in _INTERPRET_CASES],
    # the word boundaries (K = 400: the last word part full),
    *[(k, 6, k, integer, prefix, d, False) for k in (1, 63, 64, 65, 400)
      for integer, prefix, d in ((False, True, 0.0), (True, False, 1.0), (True, True, -1.0))],
    # NaN, degenerate boxes and a lane valid only in its last row.
    (12, 6, 65, False, True, 0.0, True),
    (13, 6, 400, True, False, -1.0, True),
]


@pytest.mark.parametrize("seed, lanes, k, integer, prefix, d, hard", _TWO_PASS_CASES)
def test_two_pass_equals_greedy(seed, lanes, k, integer, prefix, d, hard):
    """greedy_keep_from_mask(iou_suppression_mask(...)) is bit-equal to the
    plain greedy_nms_mask, the Pallas kernel (interpret) and the vmapped
    scan, and reads no word outside words_read: filling those with ones
    changes nothing."""
    boxes, valid = _random_lanes(seed, lanes, k, integer=integer, prefix=prefix)
    if hard:
        make_hard(boxes, valid)
    elif not prefix and lanes > 5:
        valid[3] = False  # an empty lane
        valid[5] = False
        valid[5, k - 1] = True  # a single valid candidate in the last row
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    mask = iou_suppression_mask(b, v, 0.45, d)
    got = greedy_keep_from_mask(mask, v)
    expected = _port(boxes, valid, 0.45, d)
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(expected, _jax_scan(boxes, valid, 0.45, d))
    pallas = jax_pallas_nms(jnp.asarray(boxes), jnp.asarray(valid), 0.45, d, interpret=True)
    np.testing.assert_array_equal(expected, np.asarray(pallas))
    unread = ~words_read(v)
    assert torch.equal(greedy_keep_from_mask(torch.where(unread, -1, mask), v), got)

