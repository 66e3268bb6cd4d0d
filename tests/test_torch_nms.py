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

from ssd_keras_tpu.kernels.nms_pallas import greedy_nms_mask_batched as jax_pallas_nms
from ssd_keras_tpu.ops.nms import greedy_nms_mask as jax_scan_nms
from ssd_keras_torch.kernels import nms as nms_kernel
from ssd_keras_torch.ops.nms import greedy_nms_mask

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
@pytest.mark.parametrize(
    "seed, lanes, k, integer, prefix, d",
    [
        (0, 5, 37, False, True, 0.0),
        (2, 6, 33, True, True, 0.0),
        (2, 6, 33, True, True, 1.0),
        (2, 6, 33, True, True, -1.0),
        (7, 9, 41, False, False, 0.0),
        (1, 300, 40, False, True, 0.0),
    ],
)
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
    before = nms_kernel.launches
    got = nms_kernel.greedy_nms_mask_batched(
        torch.from_numpy(boxes), torch.from_numpy(valid), 0.45
    )
    assert nms_kernel.launches == before
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

