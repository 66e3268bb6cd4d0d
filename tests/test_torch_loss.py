"""The port's SSD loss against the JAX package's, on encoder-made targets.

``y_true`` comes from the port's encoder (equal to the JAX encoder's, see
tests/test_torch_encoder.py) on SSD7 anchors; ``y_pred`` holds softmaxed
random logits, random offsets and the anchors. The per-item loss must agree
within 1e-5 relative (f32 sums in another order), and the gradient with
respect to ``y_pred`` within 1e-5 relative to its largest entry. A case with
tied negative losses checks that both sides keep the same negatives at the
cut: a different choice there moves the gradient of whole anchors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_keras_tpu.loss import SSDLoss as JaxSSDLoss
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.encoder import SSDInputEncoder
from ssd_keras_torch.loss import SSDLoss
from ssd_keras_torch.models import ssd7_predictor_sizes

torch.set_num_threads(2)

RTOL = 1e-5


def _batch(seed, ties=False, no_positives=False):
    cfg = SSDConfig.ssd7(n_classes=5, img_height=64, img_width=64)
    encoder = SSDInputEncoder(cfg, ssd7_predictor_sizes(64, 64), max_gt_boxes=8, device="cpu")
    rng = np.random.RandomState(seed)
    labels = []
    for _ in range(3):
        k = 0 if no_positives else rng.randint(1, 6)
        wh = rng.uniform(8, 40, (k, 2))
        xy = rng.uniform(0, 1, (k, 2)) * (64 - wh)
        cls = rng.randint(1, 6, (k, 1))
        labels.append(np.concatenate([cls, xy, xy + wh], axis=1))
    y_true = encoder(labels)
    b, n, _ = y_true.shape
    logits = rng.randn(b, n, 6).astype(np.float32) * 2
    if ties:  # three distinct rows: negative losses tie in large groups
        logits = logits[0, :3][rng.randint(0, 3, (b, n))]
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    offsets = rng.randn(b, n, 4).astype(np.float32) * 1.5
    y_pred = np.concatenate([probs, offsets, y_true[..., -8:]], axis=-1).astype(np.float32)
    return y_true, y_pred


def _compare(y_true, y_pred, **kw):
    jax_loss = JaxSSDLoss(**kw)
    expected = np.asarray(jax_loss.compute_loss(jnp.asarray(y_true), jnp.asarray(y_pred)))
    exp_grad = np.asarray(jax.grad(lambda p: jax_loss(jnp.asarray(y_true), p))(jnp.asarray(y_pred)))
    pred = torch.from_numpy(y_pred).requires_grad_()
    got = SSDLoss(**kw).compute_loss(torch.from_numpy(y_true), pred)
    got.mean().backward()
    np.testing.assert_allclose(got.detach().numpy(), expected, rtol=RTOL)
    grad = pred.grad.numpy()
    np.testing.assert_allclose(grad, exp_grad, rtol=0, atol=RTOL * np.abs(exp_grad).max())
    return got.detach().numpy()


@pytest.mark.parametrize("kw", [{}, {"alpha": 0.5}, {"n_neg_min": 100}, {"neg_pos_ratio": 1}])
def test_loss_equals_jax(kw):
    y_true, y_pred = _batch(0)
    loss = _compare(y_true, y_pred, **kw)
    assert np.all(loss > 0)


def test_tied_negative_losses_equal_jax():
    y_true, y_pred = _batch(1, ties=True)
    neg = -np.log(y_pred[..., 0])[y_true[..., 0] == 1]
    assert len(np.unique(neg)) == 3  # the cut falls inside a tie group
    _compare(y_true, y_pred)


@pytest.mark.parametrize("n_neg_min", [0, 50])
def test_no_positives_equal_jax(n_neg_min):
    y_true, y_pred = _batch(2, no_positives=True)
    assert y_true[..., 1:-12].max() == 0
    loss = _compare(y_true, y_pred, n_neg_min=n_neg_min)
    assert np.all(np.isfinite(loss))
    assert (loss.sum() > 0) == (n_neg_min > 0)  # k = 0 keeps no negative


def test_mining_keeps_lowest_index_among_ties():
    """Four equal negative losses and one positive: k = 3 keeps the first
    three by flat index across the batch."""
    n = 3
    y_true = np.zeros((2, n, 3 + 12), np.float32)
    y_true[..., 0] = 1
    y_true[0, 0, 0], y_true[0, 0, 1] = 0, 1  # one positive
    y_pred = np.zeros_like(y_true)
    y_pred[..., :3] = [0.5, 0.25, 0.25]
    got = SSDLoss().compute_loss(torch.from_numpy(y_true), torch.from_numpy(y_pred))
    ce = -np.log(0.5)
    pos = -np.log(0.25)
    # Item 0 keeps its two negatives (flat 1, 2), item 1 its first (flat 3).
    np.testing.assert_allclose(got.numpy(), [(pos + 2 * ce) * 2, ce * 2], rtol=1e-6)
