"""The SSD multitask loss with hard negative mining over the whole batch.

Port of ``ssd_keras_tpu/loss.py``. The data-dependent count of hard
negatives stays a device tensor: a stable descending order of the flattened
B*N negative losses, inverted by a scatter, gives every negative its rank,
and ``rank < k`` keeps the top k with the lowest index first among equal
losses, as ``tf.nn.top_k`` and the JAX package's argsort-of-argsort do. No
value is read on the host.
"""

from __future__ import annotations

import torch

__all__ = ["SSDLoss", "smooth_l1_loss", "softmax_log_loss"]


def smooth_l1_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Huber/smooth-L1, summed over the last (coordinate) axis."""
    diff = y_true - y_pred
    absolute = diff.abs()
    return torch.where(absolute < 1.0, 0.5 * diff * diff, absolute - 0.5).sum(dim=-1)


def softmax_log_loss(y_true: torch.Tensor, y_pred_probs: torch.Tensor) -> torch.Tensor:
    """Cross-entropy against already-softmaxed probabilities, clamped at
    1e-15 before the log (the model emits probabilities, as the reference
    does)."""
    return -(y_true * torch.log(torch.clamp_min(y_pred_probs, 1e-15))).sum(dim=-1)


class SSDLoss:
    """Multitask SSD loss: softmax CE + alpha * smooth-L1, hard-negative mined.

    ``compute_loss(y_true, y_pred)`` returns the per-batch-item vector of
    shape ``(batch,)``; ``__call__`` its mean, the scalar training loss. The
    normalisation is by the positive count of the whole batch, then times
    the batch size, as in the reference (keras_ssd_loss.py:204-209).
    """

    def __init__(self, neg_pos_ratio: int = 3, n_neg_min: int = 0, alpha: float = 1.0):
        self.neg_pos_ratio = neg_pos_ratio
        self.n_neg_min = n_neg_min
        self.alpha = alpha

    def compute_loss(self, y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        batch_size, n_boxes = y_pred.shape[:2]

        classification_loss = softmax_log_loss(y_true[:, :, :-12], y_pred[:, :, :-12])
        localization_loss = smooth_l1_loss(y_true[:, :, -12:-8], y_pred[:, :, -12:-8])

        negatives = y_true[:, :, 0]  # background one-hot bit; (B, N)
        positives = y_true[:, :, 1:-12].amax(dim=-1)  # (B, N)
        n_positive = positives.sum()

        pos_class_loss = (classification_loss * positives).sum(dim=-1)  # (B,)

        # Hard negative mining over the flattened batch.
        neg_class_loss_all = (classification_loss * negatives).reshape(-1)  # (B*N,)
        n_neg_losses = (neg_class_loss_all > 0.0).sum()
        n_negative_keep = torch.minimum(
            torch.clamp_min(self.neg_pos_ratio * n_positive.to(torch.int32), self.n_neg_min),
            n_neg_losses,
        )
        # With no negative loss above 0, k == 0 and nothing is kept.
        order = torch.argsort(-neg_class_loss_all.detach(), stable=True)
        ranks = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=order.device)
        )
        negatives_keep = (ranks < n_negative_keep).to(neg_class_loss_all.dtype)
        neg_class_loss = (neg_class_loss_all * negatives_keep).reshape(batch_size, n_boxes).sum(dim=-1)

        class_loss = pos_class_loss + neg_class_loss
        loc_loss = (localization_loss * positives).sum(dim=-1)

        total = (class_loss + self.alpha * loc_loss) / torch.clamp_min(n_positive, 1.0)
        return total * batch_size

    def __call__(self, y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        """Scalar loss: the mean of the per-batch-item vector."""
        return self.compute_loss(y_true, y_pred).mean()
