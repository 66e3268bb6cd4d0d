"""``ssd_keras_torch.graft_entry`` against ``__graft_entry__.py``, the JAX
package's graft entry, on the CPU.

The port's ``entry`` is SSD300 at full width in 'training' mode with bf16
compute and the JAX entry's input bytes. With the JAX entry's own
parameters moved in by ``weights_io.from_flax_params``, the port's bf16
forward of the first image agrees with the JAX bf16 forward within twice
the JAX package's own bf16-vs-f32 distance, by part of the output. That
distance, as a relative L2 norm of the difference on the first image, was
0.0698 on the class probabilities (columns 0-20) and 0.0102 on the box
offsets (21-24) on this CPU; the port's bf16 forward lay 0.0600 and 0.0078
from the JAX one. The anchors (25-32) are equal. In f32 the two lie within
1e-4 of each other. ``chip_smoke.ENTRY_BF16_REL_L2``, the tolerance of the
card's bf16-vs-f32 check (phase 17), is twice that JAX distance.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as J
from chip_smoke import ENTRY_BF16_REL_L2
from chip_smoke import ENTRY_PARTS as PARTS  # columns of the (B, 8732, 33) output
from ssd_keras_torch import graft_entry as G
from ssd_keras_torch.parallel import dryrun
from ssd_keras_torch.weights_io import from_flax_params
from ssd_keras_tpu.config import SSDConfig as JaxConfig
from ssd_keras_tpu.models import ssd_300 as jax_ssd_300

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
F32_REL_L2 = 1e-4


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    d = got.astype(np.float64) - want
    return float(np.linalg.norm(d) / max(np.linalg.norm(want.astype(np.float64)), 1e-30))


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX entry (its model init runs at batch 8), and its forward of the
    first image in bf16 and f32 with the same parameters."""
    forward, (variables, x) = J.entry()
    outs = {}
    for name, dtype in (("bf16", jax.numpy.bfloat16), ("f32", jax.numpy.float32)):
        model, _ = jax_ssd_300(JaxConfig.ssd300(), mode="training", compute_dtype=dtype)
        outs[name] = np.asarray(jax.jit(model.apply)(variables, x[:1]), np.float64)
    return dict(forward=forward, variables=variables, x=x, out=outs)


@pytest.fixture(scope="module")
def port_out(jax_entry):
    """The port's forward of the first image with the JAX parameters, in
    bf16 (the entry's model) and f32."""
    params = jax.tree_util.tree_map(np.asarray, jax_entry["variables"]["params"])
    x = torch.from_numpy(G.example_batch()[:1])
    outs = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = G.entry_model("cpu", dtype)
        model.load_state_dict(from_flax_params(params))
        with torch.no_grad():
            outs[name] = G.forward(model, x).numpy()
    return outs


def test_input_is_the_jax_entrys_bytes(jax_entry):
    x = G.example_batch()
    assert x.dtype == np.float32 and x.shape == (8, 300, 300, 3)
    np.testing.assert_array_equal(x, np.asarray(jax_entry["x"]))
    _, (_, xt) = G.entry(device="cpu")
    np.testing.assert_array_equal(xt.numpy(), x)


def test_forward_has_the_shape_and_dtype_of_jax_eval_shape(jax_entry):
    want = jax.eval_shape(jax_entry["forward"], jax_entry["variables"], jax_entry["x"])
    forward, (model, x) = G.entry(device="cpu")
    assert model.mode == "training" and model.compute_dtype == torch.bfloat16
    assert x.device.type == "cpu"
    with torch.no_grad():
        y = forward(model, x)
    assert tuple(y.shape) == tuple(want.shape) == (8, 8732, 33)
    assert str(y.dtype).replace("torch.", "") == str(want.dtype)
    assert torch.isfinite(y).all()


def test_jax_parameters_cover_the_port_model(jax_entry):
    params = jax.tree_util.tree_map(np.asarray, jax_entry["variables"]["params"])
    model = G.entry_model("cpu")
    state = from_flax_params(params)
    assert set(state) == set(model.state_dict())
    for name, value in model.state_dict().items():
        assert tuple(state[name].shape) == tuple(value.shape), name


@pytest.mark.parametrize("part", sorted(PARTS))
def test_bf16_forward_agrees_with_jax_within_its_own_bf16_distance(part, jax_entry, port_out):
    cols = PARTS[part]
    jax_bf16, jax_f32 = (jax_entry["out"][k][..., cols] for k in ("bf16", "f32"))
    got = port_out["bf16"][..., cols]
    assert got.shape == jax_bf16.shape == (1, 8732, cols.stop - cols.start)
    if part == "anchors":
        np.testing.assert_array_equal(got, jax_bf16)
        return
    own = _rel_l2(jax_bf16, jax_f32)
    assert 0 < own < 0.2, own
    assert _rel_l2(got, jax_bf16) <= 2 * own
    # The mean distance too: a few saturated softmax rows must not carry it.
    assert np.abs(got - jax_bf16).mean() <= 2 * np.abs(jax_bf16 - jax_f32).mean()


@pytest.mark.parametrize("part", sorted(PARTS))
def test_f32_forward_agrees_with_jax(part, jax_entry, port_out):
    cols = PARTS[part]
    assert _rel_l2(port_out["f32"][..., cols], jax_entry["out"]["f32"][..., cols]) <= F32_REL_L2


@pytest.mark.parametrize("part", ["probs", "boxes"])
def test_card_tolerance_is_twice_the_jax_bf16_distance(part, jax_entry):
    """Phase 17's bf16-vs-f32 bound is twice the JAX package's own distance,
    to the rounding of the stated constant."""
    cols = PARTS[part]
    own = _rel_l2(jax_entry["out"]["bf16"][..., cols], jax_entry["out"]["f32"][..., cols])
    assert 2 * own <= ENTRY_BF16_REL_L2[part] <= 2.1 * own


def test_captured_forward_takes_a_cuda_input_only():
    forward, (model, x) = G.entry(device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        G.CapturedForward(forward, model, x[:1])


def test_dryrun_multichip_is_the_data_parallel_dry_run():
    assert G.dryrun_multichip is dryrun.dryrun_multichip


def test_main_runs_the_dry_run_on_gloo_ranks():
    env = dict(os.environ, N_DEVICES="2")
    proc = subprocess.run([sys.executable, "-m", "ssd_keras_torch.graft_entry"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip OK: 2 gloo ranks on the CPU" in proc.stdout
