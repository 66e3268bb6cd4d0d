"""The port on a CUDA card: the kernel against its plain version.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so it also runs on a machine with
a card and no JAX (``tests/conftest.py`` imports JAX, hence the flag):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ssd_keras_torch import SSDConfig, SSDPredictor, ssd_300
from ssd_keras_torch.decoder import decode_detections_fast_fixed, decode_detections_fixed
from ssd_keras_torch.kernels import nms as nms_kernel
from ssd_keras_torch.models import ssd300_predictor_sizes
from ssd_keras_torch.ops.nms import greedy_nms_mask

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lanes(seed, lanes, k, prefix):
    """(L, K, 4) overlapping corner boxes in a 300x300 frame, (L, K) valid."""
    rng = np.random.RandomState(seed)
    centre = rng.rand(lanes, k, 2) * 300
    half = (10 + rng.rand(lanes, k, 2) * 90) / 2
    boxes = np.concatenate([centre - half, centre + half], axis=-1).astype(np.float32)
    if prefix:
        valid = np.arange(k)[None, :] < rng.randint(k // 2, k + 1, size=(lanes, 1))
    else:
        valid = rng.rand(lanes, k) > 0.4
        valid[::7] = False  # empty lanes
    return boxes, valid


@pytest.mark.parametrize(
    "lanes, k, prefix, d",
    [(160, 400, True, 0.0), (640, 400, False, 1.0), (8, 400, True, -1.0),
     (3, 37, False, 0.0), (2, 3000, True, 0.0)],  # K past 48 KB of shared memory
)
def test_kernel_equals_plain(cuda, lanes, k, prefix, d):
    boxes, valid = _lanes(0, lanes, k, prefix)
    b, v = torch.from_numpy(boxes).to(cuda), torch.from_numpy(valid).to(cuda)
    before = nms_kernel.launches
    got = nms_kernel.greedy_nms_mask_batched(b, v, 0.45, d)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    assert torch.equal(got, greedy_nms_mask(b, v, 0.45, d))
    assert torch.equal(got.cpu(), greedy_nms_mask(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45, d))


def test_kernel_on_empty_lanes_launches_nothing(cuda):
    keep = nms_kernel.greedy_nms_mask_batched(
        torch.zeros(0, 400, 4, device=cuda), torch.zeros(0, 400, dtype=torch.bool, device=cuda))
    assert keep.shape == (0, 400)


def _y_pred(n_classes, batch=2, seed=0):
    cfg = SSDConfig.ssd300(n_classes=n_classes, dataset="coco" if n_classes == 80 else "voc")
    anchors = cfg.anchor_tensor(ssd300_predictor_sizes(300, 300)).astype(np.float32)
    rng = np.random.RandomState(seed)
    logits = rng.randn(batch, anchors.shape[0], n_classes + 1).astype(np.float32) * 2.5
    e = np.exp(logits - logits.max(-1, keepdims=True))
    confs = e / e.sum(-1, keepdims=True)
    offsets = rng.randn(batch, anchors.shape[0], 4).astype(np.float32) * 0.5
    return torch.from_numpy(np.concatenate(
        [confs, offsets, np.broadcast_to(anchors, (batch, anchors.shape[0], 8))], axis=-1
    ).astype(np.float32))


@pytest.mark.parametrize("n_classes, fast", [(20, False), (80, False), (20, True)])
def test_decoder_on_card_equals_cpu(cuda, n_classes, fast):
    """One y_pred decoded on the card (the kernel) and on the CPU (the plain
    version): the same rows, scores equal, boxes within 1e-3 px (the two
    devices' ``exp`` may differ in the last ulp)."""
    y_pred = _y_pred(n_classes)
    decode = decode_detections_fast_fixed if fast else decode_detections_fixed
    kw = dict(confidence_thresh=0.3 if fast else 0.01, img_height=300, img_width=300)
    got = decode(y_pred.to(cuda), **kw).cpu()
    expected = decode(y_pred, **kw)
    assert torch.equal(got[..., :2], expected[..., :2])
    torch.testing.assert_close(got[..., 2:], expected[..., 2:], rtol=0, atol=1e-3)


def test_predictor_serves_on_card(cuda):
    model, _ = ssd_300(SSDConfig.ssd300(), mode="inference", compute_dtype=torch.bfloat16,
                       device=cuda, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.conv1_1.weight.mul_(0.01)
    frames = [np.random.RandomState(i).randint(0, 256, (480, 640, 3), dtype=np.uint8)
              for i in range(3)]
    before = nms_kernel.launches
    out = SSDPredictor(model, batch_size=2).predict(frames)
    assert nms_kernel.launches == before + 2  # two chunks, one launch each
    assert len(out) == 3
    for dets in out:
        assert dets.shape[1] == 6 and len(dets) > 0 and np.isfinite(dets).all()
