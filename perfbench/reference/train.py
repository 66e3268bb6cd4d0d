"""SSD training in plain PyTorch: target encoding, the multibox loss with
hard negative mining, the L2 penalty and SGD with momentum, float32.

Encoding (ssd_keras's ``SSDInputEncoder``): IoU of every ground-truth box
with every anchor in normalised corners; greedy bipartite matching (the
highest IoU of the whole matrix first, its row and column then zeroed,
once a box); then each anchor not taken to its best box at
``pos_iou_threshold`` or more; an anchor left whose best IoU is at least
``neg_iou_limit`` is neutral (all-zero class row); matched anchors carry
their box's class and centroid offsets over the variances, the rest the
background class and zero offsets.

Loss (ssd_keras's ``SSDLoss``): softmax cross-entropy of the positives and
of the ``neg_pos_ratio`` x positives hardest negatives of the whole batch,
plus smooth-L1 of the positives' offsets, over the batch's positive count;
the step adds ``l2_reg`` x the squared convolution kernels, clips the
gradients to a global norm of ``clipnorm``, and SGD with momentum (no
dampening) updates every parameter at a learning rate warmed up linearly.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.reference import ssd


def encode(config: dict, labels: torch.Tensor, n_valid: torch.Tensor,
           anchor8: torch.Tensor) -> torch.Tensor:
    """y_true (B, N, classes + 12) for padded labels (B, M, 5) [class, x1,
    y1, x2, y2] in the model's pixels and counts (B,)."""
    classes = config["n_classes"] + 1
    a = anchor8[:, :4]
    var = anchor8[:, 4:]
    a_corners = torch.stack([a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2,
                             a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2], -1)
    size = torch.tensor([config["img_width"], config["img_height"]] * 2,
                        dtype=torch.float32, device=labels.device)
    out = []
    for b in range(labels.shape[0]):
        k = int(n_valid[b])
        gt = labels[b, :k, 1:5] / size
        cls = labels[b, :k, 0].long()
        iw = (torch.minimum(gt[:, None, 2], a_corners[None, :, 2])
              - torch.maximum(gt[:, None, 0], a_corners[None, :, 0])).clamp_min(0)
        ih = (torch.minimum(gt[:, None, 3], a_corners[None, :, 3])
              - torch.maximum(gt[:, None, 1], a_corners[None, :, 1])).clamp_min(0)
        inter = iw * ih
        area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
        area_a = (a_corners[:, 2] - a_corners[:, 0]) * (a_corners[:, 3] - a_corners[:, 1])
        iou = inter / (area_g[:, None] + area_a[None, :] - inter)  # (k, N)
        assigned = torch.full((a.shape[0],), -1, dtype=torch.long, device=labels.device)
        work = iou.clone()
        for _ in range(k):  # bipartite: one anchor a box, best pairs first
            flat = int(work.argmax())
            g, j = divmod(flat, work.shape[1])
            assigned[j] = g
            work[g, :] = 0
            work[:, j] = 0
        rest = iou * (assigned < 0).float()[None, :]
        if k:
            best, which = rest.max(0)
            multi = (best >= config["pos_iou_threshold"]) & (assigned < 0)
            assigned = torch.where(multi, which, assigned)
            rest = torch.where(multi[None, :], torch.zeros_like(rest), rest)
            neutral = rest.max(0).values >= config["neg_iou_limit"]
        else:
            neutral = torch.zeros_like(assigned, dtype=torch.bool)
        matched = assigned >= 0
        safe = assigned.clamp_min(0)
        one_hot = torch.zeros((a.shape[0], classes), device=labels.device)
        if k:
            one_hot[matched, cls[safe[matched]]] = 1.0
        one_hot[~matched & ~neutral, 0] = 1.0
        offsets = torch.zeros((a.shape[0], 4), device=labels.device)
        if k:
            g = gt[safe[matched]]
            gc = torch.stack([(g[:, 0] + g[:, 2]) / 2, (g[:, 1] + g[:, 3]) / 2,
                              g[:, 2] - g[:, 0], g[:, 3] - g[:, 1]], -1)
            am, vm = a[matched], var[matched]
            offsets[matched] = torch.cat([(gc[:, :2] - am[:, :2]) / (am[:, 2:] * vm[:, :2]),
                                          torch.log(gc[:, 2:] / am[:, 2:]) / vm[:, 2:]], -1)
        out.append(torch.cat([one_hot, offsets, anchor8], -1))
    return torch.stack(out)


def multibox_loss(y_true: torch.Tensor, scores: torch.Tensor, offsets: torch.Tensor,
                  neg_pos_ratio: int = 3, alpha: float = 1.0) -> torch.Tensor:
    classes = scores.shape[-1]
    target = y_true[..., :classes]
    ce = -(target * torch.log(scores.clamp_min(1e-15))).sum(-1)  # (B, N)
    diff = (y_true[..., classes:classes + 4] - offsets).abs()
    loc = torch.where(diff < 1, 0.5 * diff * diff, diff - 0.5).sum(-1)
    pos = target[..., 1:].amax(-1)
    neg = target[..., 0]
    n_pos = pos.sum()
    neg_ce = (ce * neg).detach().reshape(-1)
    k = int(min(neg_pos_ratio * int(n_pos), int((neg_ce > 0).sum())))
    keep = torch.zeros_like(neg_ce)
    keep[torch.argsort(-neg_ce, stable=True)[:k]] = 1.0
    keep = keep.reshape(ce.shape)
    total = (ce * pos).sum() + (ce * neg * keep).sum() + alpha * (loc * pos).sum()
    return total / n_pos.clamp_min(1.0)


def learning_rate(opt: dict, step: int) -> float:
    """A linear warm-up from ``warmup_from`` of ``lr`` over ``warmup_steps``,
    then ``lr``."""
    if step >= opt["warmup_steps"]:
        return opt["lr"]
    start = opt["lr"] * opt["warmup_from"]
    return (start - opt["lr"]) * (1.0 - step / opt["warmup_steps"]) + opt["lr"]


def l2_kernels(config: dict) -> List[str]:
    """The parameters the L2 penalty covers: the convolution kernels, which
    the architecture draws He-normal (a BatchNorm's weight is not one)."""
    return [k for k, (_, (rule, _)) in ssd.parameters(config).items() if rule == "he_normal"]


def sgd_steps(config: dict, params: Dict[str, torch.Tensor], batches, opt: dict,
              quantize=None):
    """SGD with momentum over ``batches`` of (float32 images (B, H, W, 3),
    y_true), the gradients clipped to a global norm of ``clipnorm``: each
    step's loss (the data term plus the L2 term), the first step's clipped
    gradient, and the parameters after the last step."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    kernels = l2_kernels(config)
    buffers = {}
    losses, first_grad = [], None
    for step, (images, y_true) in enumerate(batches):
        scores, offsets = ssd.forward(config, params, images, quantize=quantize)
        loss = multibox_loss(y_true, scores, offsets, opt["neg_pos_ratio"])
        loss = loss + opt["l2_reg"] * sum(params[k].square().sum() for k in kernels)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        scale = 1.0 if float(norm) < opt["clipnorm"] else opt["clipnorm"] / float(norm)
        lr = learning_rate(opt, step)
        with torch.no_grad():
            for (name, p), g in zip(params.items(), grads):
                g = g * scale
                buf = buffers.get(name)
                buf = g.clone() if buf is None else buf.mul_(opt["momentum"]).add_(g)
                buffers[name] = buf
                p.sub_(lr * buf)
        if first_grad is None:
            first_grad = {k: b.clone() for k, b in buffers.items()}
    return losses, first_grad, {k: v.detach() for k, v in params.items()}


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              grad: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the reference leaf's norm and the median leaf's; leaves
    whose reference gradient is under a thousandth of the median leaf's
    (nought to rounding) left out."""
    g = {k: float(v.norm()) for k, v in grad.items()}
    g_med = float(torch.tensor(list(g.values())).median())
    ref = {k: float(reference[k].norm()) for k in reference}
    med = float(torch.tensor(list(ref.values())).median())
    return {k: abs(float(program[k].norm()) - ref[k]) / max(ref[k], med)
            for k in reference if g[k] >= 1e-3 * g_med}
