"""GT-to-anchor matching, batched over images (PyTorch).

Port of ``ssd_keras_tpu/ops/matching.py``. The JAX package runs each image's
greedy bipartite matching as a ``lax.scan`` under ``vmap``; here the scan is
a Python loop of exactly ``m`` steps over a ``(B, m, ...)`` state, and rows
at or past an image's ``n_valid`` are masked by tensor ops, so the loop
never reads a device value on the host.

Tie-breaking follows the JAX functions: a flat C-order argmax over an
image's matrix picks the lowest row, then the lowest column (``torch.argmax``
returns the first maximum), and the top-M reduction is a stable descending
sort, which keeps ``lax.top_k``'s lowest-index-first order among equals.
Scatters with ``mode="drop"`` become masked writes.
"""

from __future__ import annotations

import torch

__all__ = ["match_bipartite_greedy", "match_bipartite_greedy_topk", "match_multi"]


def match_bipartite_greedy(weight_matrix: torch.Tensor, n_valid: torch.Tensor):
    """Greedy bipartite matching over padded weight matrices.

    Args:
      weight_matrix: ``(B, m, n)`` similarities, rows = ground-truth boxes
        (padded to ``m``), columns = anchors. Padded rows must hold values
        ``< 0`` so they never outrank a live row (live IoUs are >= 0).
      n_valid: ``(B,)`` integer tensor, the number of real rows per image.

    Returns:
      ``(matches, consumed)``: ``(B, m)`` int64 matched anchor column per row
      (``n`` = no match), and the weights after each matched row and column
      was zeroed, as the reference mutates its copy.
    """
    b, m, n = weight_matrix.shape
    device = weight_matrix.device
    rows = torch.arange(m, device=device)
    cols = torch.arange(n, device=device)
    matches = torch.full((b, m), n, dtype=torch.int64, device=device)
    w = weight_matrix
    for i in range(m):
        live = (i < n_valid)[:, None]  # (B, 1)
        flat = w.reshape(b, m * n).argmax(dim=1)
        gt, anchor = flat // n, flat % n
        row_hit = (rows == gt[:, None]) & live  # (B, m)
        col_hit = (cols == anchor[:, None]) & live  # (B, n)
        matches = torch.where(row_hit, anchor[:, None], matches)
        # Zero (not -inf) the matched row and column, as the reference does.
        w = torch.where(row_hit[:, :, None] | col_hit[:, None, :], 0.0, w)
    return matches, w


def match_bipartite_greedy_topk(weight_matrix: torch.Tensor, n_valid: torch.Tensor):
    """Greedy bipartite matching on each row's top-``m`` columns.

    The same matches as :func:`match_bipartite_greedy` for live rows: at most
    ``m - 1`` columns are consumed before any row's turn, so each row's
    greedy match lies within its own top ``m`` columns by weight. The loop
    state shrinks from ``(B, m, n)`` to ``(B, m, m)``. Returns the ``(B, m)``
    int64 matches only (``n`` = no match).
    """
    b, m, n = weight_matrix.shape
    k = min(m, n)
    top_vals, top_cols = torch.sort(weight_matrix, dim=-1, descending=True, stable=True)
    vals, top_cols = top_vals[..., :k], top_cols[..., :k]
    device = weight_matrix.device
    rows = torch.arange(m, device=device)
    matches = torch.full((b, m), n, dtype=torch.int64, device=device)
    flat_cols = top_cols.reshape(b, m * k)
    for i in range(m):
        live = (i < n_valid)[:, None]  # (B, 1)
        flat = vals.reshape(b, m * k).argmax(dim=1, keepdim=True)
        gt = flat // k
        anchor = flat_cols.gather(1, flat)  # (B, 1)
        row_hit = (rows == gt) & live  # (B, m)
        matches = torch.where(row_hit, anchor, matches)
        # Consume: zero the matched row, and every slot that holds the
        # matched column (the reduced matrix's analogue of the column).
        consumed = row_hit[:, :, None] | ((top_cols == anchor[:, :, None]) & live[:, :, None])
        vals = torch.where(consumed, 0.0, vals)
    return matches


def match_multi(weight_matrix: torch.Tensor, threshold: float):
    """Per-anchor best-ground-truth matching with an IoU threshold.

    Args:
      weight_matrix: ``(..., m, n)``; padded or ignored rows must hold values
        below ``threshold``.
      threshold: minimum weight for a match.

    Returns:
      ``(gt_indices, matched)``: ``(..., n)`` int64 best row per column
      (first maximum wins) and the ``(..., n)`` bool mask of columns whose
      best weight met the threshold.
    """
    return weight_matrix.argmax(dim=-2), weight_matrix.amax(dim=-2) >= threshold
