"""The port's batched matching against the JAX package's, image by image.

Weights are IoU-like values from a seed, padded rows at -1 as the encoder
pads them, and ``n_valid`` runs from 0 to m. Matched indices must be equal:
the port's first-maximum argmax and stable descending sort must break every
tie as ``jnp.argmax`` and ``lax.top_k`` do, so some cases duplicate columns
(equal weights in two anchors) and quantise the weights to force ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_keras_tpu.ops import matching as jax_matching
from ssd_keras_torch.ops import matching

torch.set_num_threads(2)

M = 8


def _weights(seed, n, ties):
    """(M + 1, M, n) weights, image b with n_valid = b; (M + 1,) counts."""
    rng = np.random.RandomState(seed)
    w = rng.rand(M + 1, M, n).astype(np.float32) * 0.9
    w[rng.rand(M + 1, M, n) < 0.7] = 0.0  # most anchors miss most boxes
    if ties:
        w = np.round(w * 4) / 4  # a handful of distinct values
        dup = rng.randint(0, n, size=n // 4)
        w[:, :, dup] = w[:, :, dup[::-1]]  # duplicated columns
    n_valid = np.arange(M + 1, dtype=np.int32)
    w[np.arange(M)[None, :] >= n_valid[:, None]] = -1.0
    return w, n_valid


CASES = [(n, ties) for n in (340, 8732) for ties in (False, True)]


@pytest.mark.parametrize("n, ties", CASES)
def test_bipartite_full_equals_jax(n, ties):
    w, n_valid = _weights(0, n, ties)
    got, consumed = matching.match_bipartite_greedy(torch.from_numpy(w), torch.from_numpy(n_valid))
    for b in range(len(w)):
        exp, exp_consumed = jax_matching.match_bipartite_greedy(jnp.asarray(w[b]), jnp.int32(n_valid[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(exp))
        np.testing.assert_array_equal(consumed[b].numpy(), np.asarray(exp_consumed))


@pytest.mark.parametrize("n, ties", CASES)
def test_bipartite_topk_equals_jax(n, ties):
    w, n_valid = _weights(1, n, ties)
    got = matching.match_bipartite_greedy_topk(torch.from_numpy(w), torch.from_numpy(n_valid))
    full, _ = matching.match_bipartite_greedy(torch.from_numpy(w), torch.from_numpy(n_valid))
    np.testing.assert_array_equal(got.numpy(), full.numpy())
    for b in range(len(w)):
        exp = jax_matching.match_bipartite_greedy_topk(jnp.asarray(w[b]), jnp.int32(n_valid[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(exp))


@pytest.mark.parametrize("n, ties", CASES)
def test_multi_equals_jax(n, ties):
    w, _ = _weights(2, n, ties)
    got_idx, got_ok = matching.match_multi(torch.from_numpy(w), 0.5)
    for b in range(len(w)):
        exp_idx, exp_ok = jax_matching.match_multi(jnp.asarray(w[b]), 0.5)
        np.testing.assert_array_equal(got_idx[b].numpy(), np.asarray(exp_idx))
        np.testing.assert_array_equal(got_ok[b].numpy(), np.asarray(exp_ok))


def test_bipartite_hand_case():
    """Global max 0.9 -> box 0 takes anchor 1; box 1 then its best remaining,
    anchor 0; padded rows stay unmatched (n)."""
    w = torch.tensor([[[0.1, 0.9, 0.3], [0.8, 0.85, 0.2], [-1, -1, -1]]])
    for fn in (lambda *a: matching.match_bipartite_greedy(*a)[0],
               matching.match_bipartite_greedy_topk):
        assert fn(w, torch.tensor([2])).tolist() == [[1, 0, 3]]
