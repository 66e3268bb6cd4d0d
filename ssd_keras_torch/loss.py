"""The SSD multitask loss with hard negative mining over the whole batch.

Port of ``ssd_keras_tpu/loss.py``. The data-dependent count of hard
negatives stays a device tensor: a stable descending order of the flattened
B*N negative losses, inverted by a scatter, gives every negative its rank,
and ``rank < k`` keeps the top k with the lowest index first among equal
losses, as ``tf.nn.top_k`` and the JAX package's argsort-of-argsort do. No
value is read on the host.

Under data parallelism (``group``: the ranks' process group, each rank
holding its rows of the global batch in rank order), the loss stays the
global batch's, as the JAX package's jit over global arrays makes it: the
positive count and the hard-negative ranking are over the global batch (one
all-gather of the detached negative losses and the local positive count),
and the normalisation is by the global positive count times the global
batch size.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["SSDLoss", "smooth_l1_loss", "softmax_log_loss", "hard_negative_mask"]


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


def hard_negative_mask(neg_losses: torch.Tensor, n_positive: torch.Tensor,
                       neg_pos_ratio: int = 3, n_neg_min: int = 0, group=None):
    """The hard negatives to keep, and the positive count, of a batch.

    ``neg_losses``: (B, N) classification losses of the negatives (0
    elsewhere); ``n_positive``: the batch's positive count. Keeps the top
    ``k = min(max(ratio * n_positive, n_neg_min), #losses > 0)`` over the
    flattened batch, lowest index first among equal losses. With ``group``
    the rows are this rank's of a global batch: the ranking and the count
    are the global batch's. Returns ``(keep (B, N) as the losses' dtype,
    n_positive of the global batch)``; no gradient flows through either.
    """
    flat = neg_losses.detach().reshape(-1)
    offset = 0
    if group is not None:
        packed = torch.cat([flat, n_positive.detach().reshape(1).to(flat.dtype)])
        parts = [torch.empty_like(packed) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, packed, group=group)
        gathered = torch.stack(parts)
        n_positive = gathered[:, -1].sum()
        offset = dist.get_rank(group) * flat.numel()
        flat_all = gathered[:, :-1].reshape(-1)
    else:
        flat_all = flat
    n_neg_losses = (flat_all > 0.0).sum()
    n_negative_keep = torch.minimum(
        torch.clamp_min(neg_pos_ratio * n_positive.to(torch.int32), n_neg_min),
        n_neg_losses,
    )
    # With no negative loss above 0, k == 0 and nothing is kept.
    order = torch.argsort(-flat_all, stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device)
    )
    keep = ranks[offset:offset + flat.numel()] < n_negative_keep
    return keep.reshape(neg_losses.shape).to(neg_losses.dtype), n_positive


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

    def compute_loss(self, y_true: torch.Tensor, y_pred: torch.Tensor,
                     group=None) -> torch.Tensor:
        """The per-item vector; with ``group``, the rank's items of the
        global batch, normalised as the global batch's are."""
        batch_size = y_pred.shape[0]
        if group is not None:
            batch_size *= dist.get_world_size(group)

        classification_loss = softmax_log_loss(y_true[:, :, :-12], y_pred[:, :, :-12])
        localization_loss = smooth_l1_loss(y_true[:, :, -12:-8], y_pred[:, :, -12:-8])

        negatives = y_true[:, :, 0]  # background one-hot bit; (B, N)
        positives = y_true[:, :, 1:-12].amax(dim=-1)  # (B, N)
        pos_class_loss = (classification_loss * positives).sum(dim=-1)  # (B,)

        # Hard negative mining over the flattened (global) batch.
        neg_class_loss_all = classification_loss * negatives  # (B, N)
        negatives_keep, n_positive = hard_negative_mask(
            neg_class_loss_all, positives.sum(), self.neg_pos_ratio, self.n_neg_min, group)
        neg_class_loss = (neg_class_loss_all * negatives_keep).sum(dim=-1)

        class_loss = pos_class_loss + neg_class_loss
        loc_loss = (localization_loss * positives).sum(dim=-1)

        total = (class_loss + self.alpha * loc_loss) / torch.clamp_min(n_positive, 1.0)
        return total * batch_size

    def __call__(self, y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        """Scalar loss: the mean of the per-batch-item vector."""
        return self.compute_loss(y_true, y_pred).mean()

    def local_term(self, y_true: torch.Tensor, y_pred: torch.Tensor, group) -> torch.Tensor:
        """This rank's term of the global scalar loss: the sum of its items
        over the global batch size. The ranks' terms sum to ``__call__`` of
        the global batch."""
        per_item = self.compute_loss(y_true, y_pred, group)
        return per_item.sum() / (per_item.shape[0] * dist.get_world_size(group))
