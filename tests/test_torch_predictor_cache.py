"""The predictor's per-shape program cache against the JAX package's.

``SSDPredictor(max_compiled_shapes=N)`` keeps one program per input
(height, width, dtype), LRU-bounded, as ``ssd_keras_tpu/predictor.py`` keeps
one jitted program per shape. On the card an entry is a CUDA graph
(``tests/test_torch_cuda.py`` holds it to the eager path there); on the CPU
it is the eager forward, and the bookkeeping is the same code.

SSD7 at 64x64 (3 classes) with flax's init, the box heads scaled so that
decoded boxes stay near their anchors, and BatchNorm statistics moved away
from their init, on both sides through ``from_flax_params``; uint8 frames
of 64, 72 and 80 pixels from a numpy seed.
"""

import jax
import numpy as np
import pytest
import torch

from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.models import ssd_7 as jax_ssd_7
from ssd_keras_tpu.predictor import SSDPredictor as JaxSSDPredictor
from ssd_keras_torch import SSDConfig, SSDPredictor, from_flax_params, ssd_7
from ssd_keras_torch.predictor import device_resize_batch
from ssd_keras_torch.utils import profiling

torch.set_num_threads(2)

# The tolerances of tests/test_torch_slice.py: the trunk's y_pred differs
# between XLA and PyTorch by summation order, and the two libraries' resize
# weights by f32 rounding; a flipped NMS or threshold decision removes a
# whole row, which the row matching reports.
SCORE_TOL = 1e-5
BOX_TOL = 2e-3
SIZES = (64, 72, 80)
KW = dict(n_classes=3, img_height=64, img_width=64)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def shared():
    """(flax inference model, its variables, two port state_dicts, frames)."""
    model, _ = jax_ssd_7(JaxSSDConfig.ssd7(**KW), mode="inference", s2d_trunk=False)
    variables = model.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32))
    rng = np.random.RandomState(1)
    params, stats = _numpy(variables["params"]), _numpy(variables["batch_stats"])
    for layer in stats.values():
        layer["mean"] = rng.randn(*layer["mean"].shape).astype(np.float32) * 0.1
        layer["var"] = rng.uniform(0.5, 2.0, layer["var"].shape).astype(np.float32)
    for name in ("boxes4", "boxes5", "boxes6", "boxes7"):  # offsets of a trained model's size
        params[name]["kernel"] = params[name]["kernel"] * 0.05
    other = {name: {k: v * rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
                    for k, v in layer.items()} for name, layer in params.items()}
    frames = np.random.RandomState(5)
    imgs = {s: frames.randint(0, 255, (s, s, 3), dtype=np.uint8) for s in SIZES}
    return (model, {"params": params, "batch_stats": stats}, from_flax_params(params, stats),
            from_flax_params(other, stats), imgs)


def _port_model(state):
    model, _ = ssd_7(SSDConfig.ssd7(**KW), mode="inference", device="cpu")
    model.load_state_dict(state)
    return model


def _assert_rows_match(got, expected, what):
    """Every row of ``expected`` has one row of ``got`` with its class, its
    score within SCORE_TOL and its box within BOX_TOL, and none is left."""
    assert len(expected) > 10, what
    free = list(range(len(got)))
    for row in expected:
        j = next((j for j in free if got[j, 0] == row[0]
                  and abs(got[j, 1] - row[1]) <= SCORE_TOL
                  and np.all(np.abs(got[j, 2:] - row[2:]) <= BOX_TOL)), None)
        assert j is not None, f"{what}: JAX row {row.tolist()} has no match"
        free.remove(j)
    assert not free, f"{what}: port rows {got[free].tolist()} have no match"


def _keys(predictor):
    return list(predictor._compiled)


def test_compiled_cache_lru_equals_jax(shared):
    """tests/test_models.py's LRU case on both predictors side by side: the
    same keys held and evicted in the same order, a hit moving its key to
    the end, the same detections after a recapture, and each answer equal
    to JAX's."""
    flax_model, variables, state, _, imgs = shared
    jax_pred = JaxSSDPredictor(flax_model, variables, batch_size=1, max_compiled_shapes=2)
    port = SSDPredictor(_port_model(state), batch_size=1, max_compiled_shapes=2)
    key = {s: (s, s, "|u1") for s in SIZES}

    def both(size):
        got, expected = port([imgs[size]])[0], jax_pred([imgs[size]])[0]
        _assert_rows_match(got, expected, f"{size}x{size}")
        assert _keys(port) == list(jax_pred._compiled)
        return got

    first = both(64)
    both(72)
    assert _keys(port) == [key[64], key[72]]
    both(80)  # evicts the (64, 64) program
    assert _keys(port) == [key[72], key[80]]
    again = both(64)  # made again, the same result
    np.testing.assert_array_equal(again, first)
    assert _keys(port) == [key[80], key[64]]
    both(80)  # a hit: (80, 80) becomes the most recent
    assert _keys(port) == [key[64], key[80]]
    both(72)  # evicts (64, 64), the least recent
    assert _keys(port) == [key[80], key[72]]


@pytest.mark.parametrize("bound, held", [(0, 1), (1, 1), (16, 3)])
def test_cache_bound_is_at_least_one(shared, bound, held):
    """``max(1, max_compiled_shapes)`` entries, as in the JAX predictor."""
    _, _, state, _, imgs = shared
    port = SSDPredictor(_port_model(state), batch_size=1, max_compiled_shapes=bound)
    for s in SIZES:
        port([imgs[s]])
    assert _keys(port) == [(s, s, "|u1") for s in SIZES][-held:]


def test_cached_results_equal_eager(shared):
    """A request of several shapes, three chunks of one (the drain runs
    while chunks are in flight), through the cache equals the eager resize
    and forward of each frame, row for row; the CPU never launches the NMS
    kernel."""
    _, _, state, _, imgs = shared
    model = _port_model(state)
    port = SSDPredictor(model, batch_size=1, max_compiled_shapes=2)
    frames = [imgs[64], imgs[80], imgs[64], imgs[72], imgs[64], imgs[80]]
    launches = profiling.counters().get("nms.launches", 0)
    out = port(frames)
    assert launches == profiling.counters().get("nms.launches", 0)
    assert _keys(port) == [(80, 80, "|u1"), (72, 72, "|u1")]  # groups in first-seen order
    with torch.no_grad():
        for frame, dets in zip(frames, out):
            x = torch.from_numpy(np.stack([frame]))
            x = x.float() if frame.shape[0] == 64 else device_resize_batch(x, 64, 64)
            ref = model(x)[0].numpy()
            ref = ref[ref[:, 0] != 0].copy()
            ref[:, [2, 4]] *= frame.shape[1] / 64
            ref[:, [3, 5]] *= frame.shape[0] / 64
            np.testing.assert_array_equal(dets, ref)


@pytest.mark.parametrize("change", ["load_state_dict", "in_place_step", "buffer"])
def test_changed_weights_drop_the_cached_entries(shared, change):
    """Serve, change the weights, serve again: the entries made with the old
    weights are dropped, and the answer equals a fresh predictor's on the
    new weights (on the card a kept graph would read the old cast copies)."""
    _, _, state, other, imgs = shared
    model = _port_model(state)
    port = SSDPredictor(model, batch_size=1, max_compiled_shapes=4)
    before = [port([imgs[s]])[0] for s in SIZES]
    stamp = port._weights
    with torch.no_grad():
        if change == "load_state_dict":
            model.load_state_dict(other)
        elif change == "in_place_step":
            for p in model.parameters():
                p.mul_(1.01)
        else:
            model.bn1.running_mean.add_(0.5)
    after = port([imgs[72]])[0]
    assert port._weights != stamp and _keys(port) == [(72, 72, "|u1")]
    fresh = SSDPredictor(model, batch_size=1)
    np.testing.assert_array_equal(after, fresh([imgs[72]])[0])
    assert not np.array_equal(after, before[1])
    np.testing.assert_array_equal(port([imgs[64]])[0], fresh([imgs[64]])[0])
