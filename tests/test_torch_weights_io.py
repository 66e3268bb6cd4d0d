"""Keras ``.h5`` export of the port (``weights_io.save_keras_h5_weights``)
against the JAX package's reader and writer, and the vendored tensor
samplers against the JAX package's.

A ``.h5`` written by the port from a torch module, loaded by the JAX
package's ``load_keras_h5_weights``, must give exactly the flax parameters
the port holds (``to_flax_params``), and the flax model on them the port's
y_pred (SSD7 within 1e-5; SSD300 within 1e-4: the two frameworks sum
the convolutions in other orders, which moves SSD300's offsets by ~2.4e-5
through 23 layers). The file layout must be the one the JAX package writes.
"""

import hashlib

import h5py
import jax
import numpy as np
import pytest
import torch

from ssd_keras_tpu import weights_io as jax_weights_io
from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.models import ssd_7 as jax_ssd_7
from ssd_keras_tpu.models import ssd_300 as jax_ssd_300
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.models import ssd_7, ssd_300, ssd_512
from ssd_keras_torch.weights_io import (
    from_flax_params,
    load_keras_h5_weights,
    sample_classifier_weights,
    sample_tensors,
    save_keras_h5_weights,
    to_flax_params,
)

torch.set_num_threads(2)


def _ssd7_with_stats():
    model, _ = ssd_7(SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64),
                     generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for i in range(1, 8):
            bn = getattr(model, f"bn{i}")
            c = bn.running_mean.shape[0]
            bn.running_mean.copy_(torch.from_numpy(rng.randn(c).astype(np.float32) * 0.3))
            bn.running_var.copy_(torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5))
            bn.weight.copy_(torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5))
            bn.bias.copy_(torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1))
    return model


def _ssd300():
    model, _ = ssd_300(SSDConfig.ssd300(), generator=torch.Generator().manual_seed(0),
                       device="cpu")
    with torch.no_grad():
        model.conv1_1.weight.mul_(0.01)
        model.conv4_3_norm.gamma.copy_(torch.linspace(15, 25, 512))
    return model


def _jax_load(path, model):
    """The JAX package's reader on the port-written file, into a flax tree
    shaped like the port's parameters."""
    params, stats = to_flax_params(model.state_dict())
    zeros = lambda tree: {k: {n: np.zeros_like(v) for n, v in d.items()} for k, d in tree.items()}
    return jax_weights_io.load_keras_h5_weights(
        path, zeros(params), zeros(stats) if stats else None, on_unconsumed="raise")


@pytest.mark.parametrize("arch", ["ssd7", "ssd300"])
def test_port_saved_h5_gives_jax_the_same_weights_and_y_pred(tmp_path, arch):
    model = _ssd7_with_stats() if arch == "ssd7" else _ssd300()
    path = str(tmp_path / f"{arch}.h5")
    save_keras_h5_weights(path, model)
    params, stats, loaded = _jax_load(path, model)
    want_params, want_stats = to_flax_params(model.state_dict())
    assert sorted(loaded) == sorted(want_params)
    for tree, want in ((params, want_params), (stats, want_stats)):
        assert set(tree) == set(want)
        for layer, tensors in want.items():
            assert set(tree[layer]) == set(tensors)
            for key, value in tensors.items():
                np.testing.assert_array_equal(tree[layer][key], value, err_msg=f"{layer}/{key}")

    size = 64 if arch == "ssd7" else 300
    x = np.random.RandomState(2).rand(1, size, size, 3).astype(np.float32) * 255
    if arch == "ssd7":
        flax, _ = jax_ssd_7(JaxSSDConfig.ssd7(n_classes=3, img_height=64, img_width=64))
        expected = flax.apply({"params": params, "batch_stats": stats}, x, train=False)
        tol = 1e-5
    else:
        flax, _ = jax_ssd_300(JaxSSDConfig.ssd300())
        expected = jax.jit(flax.apply)({"params": params}, x)
        tol = 1e-4
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(expected), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["ssd7", "ssd300", "ssd512"])
def test_h5_round_trips_and_layout_equals_jax_writer(tmp_path, arch):
    """Port writes, port reads: the same state. The file has the groups,
    datasets and attributes the JAX package's writer gives the same
    weights (conv4_3_norm's flat gamma, BatchNorm's Keras names)."""
    if arch == "ssd7":
        model = _ssd7_with_stats()
        fresh, _ = ssd_7(SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64), device="cpu")
    elif arch == "ssd300":
        model, (fresh, _) = _ssd300(), ssd_300(SSDConfig.ssd300(), device="cpu")
    else:
        model, _ = ssd_512(SSDConfig.ssd512(), generator=torch.Generator().manual_seed(3),
                           device="cpu")
        fresh, _ = ssd_512(SSDConfig.ssd512(), device="cpu")
    port_path, jax_path = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    save_keras_h5_weights(port_path, model)
    params, stats = to_flax_params(model.state_dict())
    jax_weights_io.save_keras_h5_weights(jax_path, params, stats or None)

    loaded = load_keras_h5_weights(port_path, fresh, on_unconsumed="raise")
    assert sorted(loaded) == sorted(params)
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key

    def layout(path):
        """Every group and dataset: its attributes, and a dataset's shape,
        dtype and bytes."""
        def content(obj):
            if not isinstance(obj, h5py.Dataset):
                return None
            value = obj[()]
            return value.shape, value.dtype.str, hashlib.sha256(value.tobytes()).hexdigest()

        out = {}
        with h5py.File(path, "r") as f:
            out["/"] = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}
            f.visititems(lambda name, obj: out.__setitem__(
                name, (content(obj), {k: np.asarray(v).tolist() for k, v in obj.attrs.items()})))
        return out

    assert layout(port_path) == layout(jax_path)
    if arch != "ssd7":
        with h5py.File(port_path, "r") as f:
            assert "conv4_3_norm_gamma:0" in f["conv4_3_norm"]


def test_jax_saved_h5_loads_into_the_port(tmp_path):
    model = _ssd7_with_stats()
    params, stats = to_flax_params(model.state_dict())
    path = str(tmp_path / "jax.h5")
    jax_weights_io.save_keras_h5_weights(path, params, stats)
    fresh, _ = ssd_7(SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64), device="cpu")
    load_keras_h5_weights(path, fresh, on_unconsumed="raise")
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    assert set(from_flax_params(params, stats)) == set(fresh.state_dict())


@pytest.mark.parametrize("instructions, init", [
    ([3, 3, 64, 40], None),  # sub-sample the last axis at random
    ([3, 3, 64, [0, 5, 9, 63]], None),  # explicit indices
    ([3, 3, 64, 90], ["gaussian"] * 4),  # up-sample with gaussian fill
    ([3, 3, 64, 90], ["zeros"] * 4),
    ([2, 3, 32, 50], None),  # several axes at once
])
def test_sample_tensors_equals_jax(instructions, init):
    rng = np.random.RandomState(4)
    kernel = rng.randn(3, 3, 64, 84).astype(np.float32)
    bias = rng.randn(84).astype(np.float32)
    out = []
    for fn in (sample_tensors, jax_weights_io.sample_tensors):
        np.random.seed(5)
        out.append(fn([kernel, bias], instructions, init=init))
    for got, expected in zip(*out):
        np.testing.assert_array_equal(got, expected)
    assert out[0][0].shape[-1] == (len(instructions[-1]) if isinstance(instructions[-1], list)
                                   else instructions[-1])


def test_sample_classifier_weights_equals_jax():
    rng = np.random.RandomState(6)
    kernel = rng.randn(3, 3, 512, 4 * 81).astype(np.float32)
    bias = rng.randn(4 * 81).astype(np.float32)
    classes = [0, 3, 8, 1, 15]
    got = sample_classifier_weights(kernel, bias, 81, classes, 4)
    expected = jax_weights_io.sample_classifier_weights(kernel, bias, 81, classes, 4)
    for g, e in zip(got, expected):
        np.testing.assert_array_equal(g, e)
    assert got[0].shape == (3, 3, 512, 20) and got[1].shape == (20,)
