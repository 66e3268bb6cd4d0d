"""The port's benchmarks (``ssd_keras_torch.bench``, ``ssd_keras_torch.bench_all``)
against the JAX package's scripts (``bench.py``, ``bench_all.py``, loaded as
modules; their ``main`` is not run) and its functions, on the CPU.

* The matrix's row names are ``BENCH_MATRIX.json``'s, in order, with the
  ``topk=approx`` row dropped and `` on-device chained`` read as
  `` device time`` (27 names); both ``BASELINE_FPS`` tables are the JAX
  scripts'.
* Each row's work function, at SSD7 64x64 with 3 classes and weights
  carried from a flax ``init`` (random BatchNorm statistics, as in
  ``test_torch_ssd7.py``) by ``weights_io.from_flax_params``, against the
  JAX package on the same numpy input: the 'training' y_pred and the
  'inference' / 'inference_fast' detections within ``Y_TOL`` = 1e-4
  (``test_torch_ssd7.py``'s: the frameworks sum the convolutions in other
  orders, ~1e-6; class ids equal; box corners in units of the 64-pixel
  image, y_pred's units, since a pixel corner is an offset times the
  anchor's size in pixels); the folded model against the JAX package's
  ``fold_batchnorm`` of the same variables within ``FOLD_TOL`` = 1e-5 (both
  fold in float64 and round once to f32; corners as above); fwd+decode against
  JAX's ``decode_detections_fixed`` of the same y_pred (class ids equal,
  scores within rtol 1e-5, boxes within rtol 1e-5 / atol 1e-4 px, as
  ``test_torch_decoder.py`` holds the decoder); one train step's loss from
  the same weights and the synthetic targets within ``LOSS_RTOL`` = 1e-4
  relative; augment + encode's shapes and dtypes equal ``jax.eval_shape``
  of the JAX script's pipeline; the predictor's two rows answer alike.
* ``bench.main`` on the CPU prints one line with every key of the JAX
  script's line; ``runs`` sorted, ``value`` the best of them; the graph
  keys null. ``bench_all.main`` writes the JAX artifact's keys under the
  temp dir. Without a card, ``--device cuda`` (the default) raises.

Timings here are the CPU's host clock at tiny sizes: the tests check keys,
names and arithmetic, never speed.
"""

import importlib.util
import json
import os
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_keras_tpu import decoder as jax_decoder
from ssd_keras_tpu import train as jax_train
from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.data.device_aug import DeviceSSDAugmentation as JaxDeviceSSDAugmentation
from ssd_keras_tpu.encoder import SSDInputEncoder as JaxSSDInputEncoder
from ssd_keras_tpu.loss import SSDLoss as JaxSSDLoss
from ssd_keras_tpu.models import ssd_7 as jax_ssd_7
from ssd_keras_tpu.optimize import fold_batchnorm as jax_fold_batchnorm
from ssd_keras_torch import SSDConfig, bench, bench_all
from ssd_keras_torch.weights_io import from_flax_params

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
KW = dict(n_classes=3, img_height=64, img_width=64)
Y_TOL = 1e-4
FOLD_TOL = 1e-5
LOSS_RTOL = 1e-4
BATCH = 2


def jax_script(name):
    """A root JAX script as a module (its main is not run; the environment
    it sets at import is put back)."""
    spec = importlib.util.spec_from_file_location(f"jax_bench_{name}", REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(module)
    return module


def mapped_jax_rows():
    rows = json.loads((REPO / "BENCH_MATRIX.json").read_text())["rows"]
    return [r["name"].replace(" on-device chained", " device time") for r in rows
            if r["name"] != "ssd300 fwd+decode(topk=approx) batch 8"]


def test_row_names_are_the_jax_matrix_mapped():
    names = bench_all.row_names()
    assert len(names) == 27
    assert names == mapped_jax_rows()


def test_baselines_are_the_jax_scripts():
    assert bench.BASELINE_FPS == jax_script("bench").BASELINE_FPS
    assert bench_all.BASELINE_FPS == jax_script("bench_all").BASELINE_FPS


def test_rows_carry_the_jax_baselines():
    """Each row's baseline is the one the JAX matrix recorded for it."""
    jax_rows = json.loads((REPO / "BENCH_MATRIX.json").read_text())["rows"]
    expected = {r["name"].replace(" on-device chained", " device time"): r["baseline"]
                for r in jax_rows}
    assert {row.name: row.baseline for row in bench_all.MATRIX} == {
        name: expected[name] for name in bench_all.row_names()}
    assert [row.name for row in bench_all.MATRIX if not row.decodes] == [
        "ssd300 train step batch 32", "device augment+encode batch 32"]


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def shared():
    """(port config, flax variables as numpy, the port's state_dict)."""
    model, _ = jax_ssd_7(JaxSSDConfig.ssd7(**KW), s2d_trunk=False)
    variables = model.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32))
    rng = np.random.RandomState(1)
    stats = _numpy(variables["batch_stats"])
    for layer in stats.values():
        layer["mean"] = rng.randn(*layer["mean"].shape).astype(np.float32) * 0.1
        layer["var"] = rng.uniform(0.5, 2.0, layer["var"].shape).astype(np.float32)
    params = _numpy(variables["params"])
    for name, layer in params.items():
        if name.startswith("bn"):
            layer["scale"] = rng.uniform(0.5, 1.5, layer["scale"].shape).astype(np.float32)
            layer["bias"] = rng.randn(*layer["bias"].shape).astype(np.float32) * 0.1
    jax_variables = {"params": params, "batch_stats": stats}
    return SSDConfig.ssd7(**KW), jax_variables, from_flax_params(params, stats)


def _jax_apply(variables, x, **build):
    model, _ = jax_ssd_7(JaxSSDConfig.ssd7(**KW), s2d_trunk=False, **build)
    return np.asarray(model.apply(variables, x))


def _assert_same_detections(got, expected, rtol, atol, scale=1.0):
    """Class ids equal (and so the row order); scores within ``rtol``; box
    corners divided by ``scale`` within ``rtol`` and ``atol``."""
    assert got.shape == expected.shape
    assert (expected[..., 1] > 0).sum() >= 10
    np.testing.assert_array_equal(got[..., 0], expected[..., 0])
    np.testing.assert_allclose(got[..., 1], expected[..., 1], rtol=rtol, atol=0)
    np.testing.assert_allclose(got[..., 2:] / scale, expected[..., 2:] / scale, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("mode", ["training", "inference", "inference_fast"])
def test_inference_work_equals_jax(shared, mode):
    config, variables, state = shared
    model, x = bench_all.inference_work("ssd7", config, mode, BATCH, torch.float32, "cpu", state)
    with torch.no_grad():
        got = model(x).numpy()
    expected = _jax_apply(variables, x.numpy(), mode=mode)
    if mode == "training":
        assert got.shape == expected.shape == (BATCH, 340, 16)
        np.testing.assert_allclose(got, expected, rtol=Y_TOL, atol=Y_TOL)
    else:
        _assert_same_detections(got, expected, Y_TOL, Y_TOL, scale=64.0)


def test_folded_work_equals_jax_fold(shared):
    config, variables, state = shared
    model, x = bench_all.folded_work(config, BATCH, torch.float32, "cpu", state)
    assert not any(name.startswith("bn") for name, _ in model.named_children())
    with torch.no_grad():
        got = model(x).numpy()
    folded = jax_fold_batchnorm(jax.tree_util.tree_map(jnp.asarray, variables))
    expected = _jax_apply(folded, x.numpy(), mode="inference", fold_bn=True)
    _assert_same_detections(got, expected, FOLD_TOL, FOLD_TOL, scale=64.0)


def test_fwd_decode_work_equals_jax_decode_of_the_same_y_pred(shared):
    config, _, state = shared
    forward, x = bench_all.fwd_decode_work("ssd7", config, BATCH, torch.float32, "cpu", state)
    trunk, _ = bench_all.build("ssd7", config, "training", torch.float32, "cpu", state)
    with torch.no_grad():
        got = forward(x).numpy()
        y_pred = trunk(x).numpy()
    expected = np.asarray(jax_decoder.decode_detections_fixed(y_pred, img_height=64,
                                                              img_width=64))
    _assert_same_detections(got, expected, 1e-5, 1e-4)


def test_synthetic_targets_are_the_jax_scripts():
    """At VOC's 21 classes and SSD300's 8732 boxes, batch 32: the JAX
    script's construction (``bench_all.py``'s train-step block), line for
    line."""
    B, N, C = 32, 8732, 21
    y = np.zeros((B, N, C + 12), np.float32)
    y[:, :, 0] = 1
    for b in range(B):
        y[b, 37 * b % N, 0] = 0
        y[b, 37 * b % N, 1 + b % 20] = 1
    np.testing.assert_array_equal(bench_all.synthetic_targets(B, N, C), y)


def test_train_step_work_loss_equals_jax(shared):
    """One step from the same weights on the same images and synthetic
    targets (batch 3, where ``1 + b % 3`` is the JAX script's ``1 + b %
    20``): the loss the step reports, taken before its update."""
    config, variables, state = shared
    step, x, y = bench_all.train_step_work("ssd7", config, 3, torch.float32, "cpu", state)
    with torch.enable_grad():
        got = float(step(x, y)["loss"])
    jax_model, _ = jax_ssd_7(JaxSSDConfig.ssd7(**KW), s2d_trunk=False)
    to_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    jax_state = jax_train.TrainState.create(
        apply_fn=jax_model.apply, params=to_jax(variables["params"]),
        tx=jax_train.sgd_with_momentum(1e-3), batch_stats=to_jax(variables["batch_stats"]))
    jax_step = jax_train.make_train_step(jax_model, JaxSSDLoss(), l2_reg=5e-4)
    _, metrics = jax_step(jax_state, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    expected = float(metrics["loss"])
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, expected, rtol=LOSS_RTOL)


def test_augment_encode_work_shapes_equal_jax():
    config = SSDConfig.ssd7(**KW)
    pipe = bench_all.augment_encode_work("ssd7", config, BATCH, "cpu")
    images, y_true = pipe(0)

    jax_config = JaxSSDConfig.ssd7(**KW)
    sizes = bench_all.ARCHS["ssd7"][1](64, 64)
    enc = JaxSSDInputEncoder(jax_config, sizes, max_gt_boxes=bench_all.MAX_GT_BOXES)
    aug = JaxDeviceSSDAugmentation(64, 64)

    def jax_pipe(key, imgs, labels, n_valid):
        out, new_labels, counts = aug(key, imgs, labels, n_valid)
        return out, enc.encode_padded(new_labels, counts)

    spec = jax.ShapeDtypeStruct
    want = jax.eval_shape(jax_pipe, jax.random.PRNGKey(1),
                          spec((BATCH, 64, 64, 3), jnp.uint8),
                          spec((BATCH, bench_all.MAX_GT_BOXES, 5), jnp.float32),
                          spec((BATCH,), jnp.int32))
    for got, expected in zip((images, y_true), want):
        assert tuple(got.shape) == expected.shape
        assert str(got.dtype).split(".")[-1] == str(expected.dtype)
    assert torch.isfinite(images).all() and torch.isfinite(y_true).all()


def test_predictor_rows_answer_alike(shared, monkeypatch):
    """The stream's answer for the first frame (PIL-like resize on the model's
    device, mapped back to the frame) and the device-resident program's rows
    for it (the same resize and forward on the f32 batch, in the model's
    frame) are the same detections."""
    monkeypatch.setattr(bench_all, "STREAM_IMAGES", 8)
    config, _, state = shared
    predictor, frames = bench_all.predictor_stream_work("ssd7", config, torch.float32, "cpu",
                                                        state)
    assert len(frames) == 8 and frames[0].shape == (480, 640, 3) and frames[0].dtype == np.uint8
    answers = predictor(frames)
    run, batch = bench_all.device_resident_work("ssd7", config, torch.float32, "cpu", state)
    assert tuple(batch.shape) == (8, 480, 640, 3) and batch.dtype == torch.float32
    rows = run(batch).numpy()
    assert rows.shape == (8, 200, 6)
    first = rows[0][rows[0][:, 0] != 0]
    first[:, [2, 4]] *= 640 / 64
    first[:, [3, 5]] *= 480 / 64
    assert len(first) > 0
    np.testing.assert_allclose(answers[0], first, rtol=1e-5, atol=1e-3)


def test_bench_main_prints_the_jax_keys_on_the_cpu(monkeypatch, capsys):
    for name, value in (("BENCH_BATCH", "1"), ("BENCH_ITERS", "1"), ("BENCH_REPEATS", "2"),
                        ("BENCH_DTYPE", "float32")):
        monkeypatch.setenv(name, value)
    record = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    jax_keys = {"metric", "value", "unit", "vs_baseline", "runs", "spread_pct"}
    assert jax_keys <= set(record)
    assert record["metric"] == "ssd300_inference_fps_batch1" and record["unit"] == "images/s"
    runs = record["runs"]
    assert len(runs) == 2 and runs == sorted(runs) and record["value"] == runs[-1] > 0
    # vs_baseline is the unrounded best over 39 rounded, as in the JAX script,
    # so it is within half a cent of value / 39 (value is rounded too).
    assert abs(record["vs_baseline"] - record["value"] / 39.0) <= 0.005 + 0.005 / 39.0
    assert 0 <= record["spread_pct"] < 100
    assert all(record[k] is None for k in ("graph_value", "graph_runs", "device_ms",
                                           "graph_bit_equal"))
    assert record["nms_launches"] == 0 and record["card"] == "cpu"
    assert record["dtype"] == "float32"


@pytest.fixture()
def small_matrix(monkeypatch, shared):
    """One row of each kind of measurement, over SSD7 64x64 families, one
    repeat each."""
    config, _, _ = shared
    monkeypatch.setattr(bench_all, "families",
                        lambda: {k: ("ssd7", config) for k in ("ssd300", "ssd512", "ssd7",
                                                               "coco")})
    monkeypatch.setattr(bench_all, "REPEATS", 1)
    monkeypatch.setattr(bench_all, "STREAM_IMAGES", 16)
    keep = {"ssd7 inference_fast batch 1", "ssd7 inference(bn-folded) batch 1",
            "ssd7 inference(bn-folded) batch 1 device time",
            "ssd300 COCO(81 classes) inference batch 8 device time",
            "ssd300 fwd+decode(topk=exact) batch 8",
            "ssd300 SSDPredictor 640x480 inputs 64-image stream (incl. host upload)",
            "ssd300 SSDPredictor 640x480 device-resident 64-image batch",
            "ssd300 train step batch 32", "device augment+encode batch 32"}
    rows = [row for row in bench_all.MATRIX if row.name in keep]
    assert len(rows) == len(keep)
    monkeypatch.setattr(bench_all, "MATRIX", rows)
    return rows


def test_bench_all_main_writes_the_jax_artifact_under_the_temp_dir(small_matrix, tmp_path,
                                                                   monkeypatch, capsys):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    artifact = bench_all.main(["--device", "cpu", "--quick"])
    out = capsys.readouterr().out.strip().splitlines()
    written = list(tmp_path.iterdir())
    assert len(written) == 1 and json.loads(written[0].read_text()) == artifact
    assert {"device", "timestamp", "n_iters", "rows"} <= set(artifact)
    assert artifact["device"] == "cpu" and artifact["n_iters"] == 10
    assert json.loads(out[-1]) == artifact["rows"]
    assert [r["name"] for r in artifact["rows"]] == [row.name for row in small_matrix]
    for row, spec in zip(artifact["rows"], small_matrix):
        assert {"name", "ms_per_batch", "throughput", "baseline", "vs_baseline", "timer",
                "nms_launches"} <= set(row)
        assert row["ms_per_batch"] > 0 and row["throughput"] > 0 and row["nms_launches"] == 0
        assert row["baseline"] == spec.baseline
        if spec.baseline:
            assert abs(row["vs_baseline"] - row["throughput"] / spec.baseline) <= 0.01
        assert row["name"] in next(line for line in out if line.startswith(row["name"]))


@pytest.mark.parametrize("module, argv", [
    ("bench", []), ("bench", ["--device", "cuda"]),
    ("bench_all", ["--out", "matrix.json"]),
    ("bench_all", ["--quick", "--device", "cuda", "--out", "matrix.json"]),
])
def test_benchmarks_default_to_the_card_and_raise_without_one(module, argv, tmp_path,
                                                             monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        {"bench": bench, "bench_all": bench_all}[module].main(argv)
    assert list(tmp_path.iterdir()) == []
