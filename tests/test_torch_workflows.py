"""The port's user workflows (``ssd_keras_torch.examples``) against the JAX
package's ``examples/`` scripts, on the CPU.

* The SynthVOC benchmark's recipes: the port's LR schedule equals the optax
  schedule of the JAX ``build_optimizer`` at every step (within 1e-7), and
  updates built from each recipe (SGD with its schedule, Adam; both clipped
  to a global norm of 5) on the same seeded parameters and gradients agree
  within 1e-6. ``ssd300_training.lr_schedule`` equals JAX's at every epoch.
* The workflow driver's SynthVOC export (VOC 07/12 XML, the image sets, the
  JPEGs, the COCO JSON and the CSV) is byte-equal to the JAX driver's.
* The driver's pass/fail rules pass the JAX driver's own test cases
  (``tests/test_workflow_driver.py``), and the h5 rows read
  ``not run: no h5py`` when h5py does not import.
* ``export_h5`` and ``weight_sampling`` write the datasets the JAX scripts
  write from the same SSD7 weights.
* Every example's ``main`` runs in-process on a tiny SynthVOC export with
  ``--device cpu`` and prints the lines the driver parses.
"""

import importlib.util
import inspect
import os
import sys
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import torch

import test_workflow_driver as jax_driver_cases
from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.models import ssd_7 as jax_ssd_7
from ssd_keras_torch import SSDConfig, ssd_7
from ssd_keras_torch.examples import (
    export_h5,
    run_workflows_synthvoc,
    ssd7_training,
    ssd300_evaluation,
    ssd300_evaluation_coco,
    ssd300_inference,
    ssd300_training,
    ssd512_inference,
    synthetic_smoke_ssd300,
    synthvoc_benchmark,
    weight_sampling,
)
from ssd_keras_torch.train import Trainer
from ssd_keras_torch.weights_io import from_flax_params

torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
CPU = ["--device", "cpu"]
F32 = [*CPU, "--compute_dtype", "float32"]


def jax_example(name):
    """A JAX package example script as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------------- #
# (i) The recipes
# ------------------------------------------------------------------------- #


@pytest.mark.parametrize("model, steps, warmup", [
    ("ssd300", 24000, 1000), ("ssd512", 300, 50), ("ssd7", 12000, 1000)])
def test_benchmark_schedule_equals_optax(model, steps, warmup):
    _, jax_sched = jax_example("synthvoc_benchmark").build_optimizer(
        model, steps, 1e-3, warmup, 5.0)
    sched = synthvoc_benchmark.lr_schedule(model, steps, 1e-3, warmup)
    got = np.array([sched(s) for s in range(steps)])
    want = np.asarray(jax_sched(jax.numpy.arange(steps)), dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    if model != "ssd7":
        assert got[0] == pytest.approx(1e-5) and got[-1] == pytest.approx(1e-5)


@pytest.mark.parametrize("model", ["ssd300", "ssd7"])
def test_benchmark_optimizer_updates_equal_optax(model):
    import optax

    rng = np.random.RandomState(0)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 3).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]  # global norm ~13 > 5: every update is clipped
    # The recipes' peak LR. Adam's bias correction 1 - 0.999**t is rounded
    # to f32 in optax (1.3e-5 relative at t = 1), so its update carries that
    # error: ~1e-8 at this rate.
    steps, peak, warmup = 10, 1e-3, 2
    tx, _ = jax_example("synthvoc_benchmark").build_optimizer(model, steps, peak, warmup, 5.0)
    jax_params = {k: jax.numpy.asarray(v) for k, v in params.items()}
    state = tx.init(jax_params)
    tensors = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt, _ = synthvoc_benchmark.build_optimizer(model, list(tensors.values()), steps, peak,
                                                warmup, 5.0)
    for g in grads:
        updates, state = tx.update({k: jax.numpy.asarray(v) for k, v in g.items()}, state,
                                   jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, t in tensors.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jax_params[k]),
                                       rtol=0, atol=1e-6, err_msg=k)


def test_ssd300_training_lr_schedule_equals_jax():
    jax_schedule = jax_example("ssd300_training").lr_schedule
    for epoch in range(150):
        assert ssd300_training.lr_schedule(epoch) == jax_schedule(epoch)


# ------------------------------------------------------------------------- #
# (ii) The driver's export
# ------------------------------------------------------------------------- #


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def test_driver_export_is_byte_equal_to_the_jax_drivers(tmp_path, monkeypatch):
    """The JAX driver's main, with its SynthVOC capped at 4 images a split
    and its rows stubbed out, against ``export_synthvoc`` at 4 images."""
    import ssd_keras_tpu.data.synthvoc as jax_synthvoc
    import ssd_keras_tpu.models as jax_models

    base = jax_synthvoc.SynthVOC

    class FourImages(base):
        def __init__(self, n_images, *args, **kwargs):
            super().__init__(min(n_images, 4), *args, **kwargs)

    def no_model(*args, **kwargs):
        raise RuntimeError("the export test builds no model")

    driver = jax_example("run_workflows_synthvoc")
    monkeypatch.setattr(jax_synthvoc, "SynthVOC", FourImages)
    monkeypatch.setattr(jax_models, "ssd_300", no_model)
    monkeypatch.setattr(driver, "run", lambda *args, **kwargs: False)
    jax_root = tmp_path / "jax"
    monkeypatch.setattr(sys, "argv", ["run_workflows_synthvoc.py", "--scale", "quick",
                                      "--root", str(jax_root), "--out", str(tmp_path / "j.md")])
    with pytest.raises(SystemExit):
        driver.main()

    port_root = tmp_path / "port"
    paths = run_workflows_synthvoc.export_synthvoc(str(port_root), 4, 4, 4)
    assert Path(paths["csv"]).exists() and Path(paths["voc_root"]).is_dir()
    names = _files(port_root)
    assert names == _files(jax_root)
    assert sum(n.endswith(".jpg") for n in names) == 16  # 07 trainval + test, 12, COCO
    assert sum(n.endswith(".xml") for n in names) == 12
    for name in names:
        assert (port_root / name).read_bytes() == (jax_root / name).read_bytes(), name


# ------------------------------------------------------------------------- #
# (iii) The driver's pass/fail rules
# ------------------------------------------------------------------------- #


def _jax_driver_cases():
    """Every test of ``tests/test_workflow_driver.py``, one case per
    parameter set."""
    cases = []
    for name, fn in inspect.getmembers(jax_driver_cases, inspect.isfunction):
        if not name.startswith("test_"):
            continue
        marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
        if not marks:
            cases.append(pytest.param(name, {}, id=name))
            continue
        (argname, values), = [m.args for m in marks]
        cases += [pytest.param(name, {argname: v}, id=f"{name}[{v}]") for v in values]
    return cases


@pytest.mark.parametrize("case, kwargs", _jax_driver_cases())
def test_port_driver_passes_the_jax_driver_cases(case, kwargs, tmp_path):
    fn = getattr(jax_driver_cases, case)
    wanted = inspect.signature(fn).parameters
    given = {"driver": run_workflows_synthvoc, "tmp_path": tmp_path, **kwargs}
    fn(**{k: given[k] for k in wanted})


def test_h5_rows_are_recorded_not_run_without_h5py(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py raises ImportError
    assert not run_workflows_synthvoc.have_h5py()
    results = []
    ok = run_workflows_synthvoc.run_h5("h5_export", ["-c", "raise SystemExit(3)"], results)
    assert not ok
    row, = results
    assert row["status"] == "not run: no h5py" and row["ok"] is False
    assert run_workflows_synthvoc.failed(results) == []
    run_workflows_synthvoc.run("fails", ["-c", "raise SystemExit(1)"], results, timeout=60)
    assert run_workflows_synthvoc.failed(results) == ["fails"]

    args = run_workflows_synthvoc.parse_args(["--root", str(tmp_path)])
    out = tmp_path / "report.md"
    run_workflows_synthvoc.write_report(str(out), args, results, (1, 1, 1), (1, 1, 1))
    text = out.read_text()
    assert "| h5_export | not run: no h5py |" in text and "| fails | FAILED |" in text
    assert "0/2 workflows passed, 1 not run" in text


def test_driver_reads_the_nms_launch_line():
    results = []
    assert run_workflows_synthvoc.run("launches", ["-c", "print('NMS kernel launches: 3')"],
                                      results, timeout=60)
    assert results[0]["nms_launches"] == 3 and results[0]["status"] == "ok"


# ------------------------------------------------------------------------- #
# (iv) .h5 export and weight sampling against the JAX scripts
# ------------------------------------------------------------------------- #


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same_datasets(got_path, want_path):
    got, want = _datasets(got_path), _datasets(want_path)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype and got[name].shape == value.shape, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_export_h5_and_weight_sampling_equal_the_jax_scripts(tmp_path, monkeypatch):
    import orbax.checkpoint as ocp

    n_classes = 4
    jax_cfg = JaxSSDConfig.ssd7(n_classes=n_classes, img_height=64, img_width=64)
    flax_model, _ = jax_ssd_7(jax_cfg)
    variables = flax_model.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32),
                                train=False)
    params = jax.device_get(variables["params"])
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map(  # BatchNorm statistics away from their init
        lambda v: (rng.rand(*v.shape) + 0.5).astype(np.float32),
        jax.device_get(variables["batch_stats"]))

    # The JAX scripts: an orbax checkpoint -> .h5 -> sampled .h5.
    jax_ckpt = str(tmp_path / "jax_ckpts" / "ckpt_3")
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(jax_ckpt, {"params": params, "batch_stats": stats})
    checkpointer.wait_until_finished()
    jax_h5, jax_sampled = str(tmp_path / "jax.h5"), str(tmp_path / "jax_sampled.h5")
    heads = ["classes4", "classes5", "classes6", "classes7"]
    sample_args = ["--classes_of_interest", "0", "2", "3", "--n_classes_source",
                   str(n_classes + 1), "--heads", *heads]
    monkeypatch.setattr(sys, "argv", ["export_h5.py", "--model", "ssd7", "--ckpt",
                                      str(tmp_path / "jax_ckpts"), "--out", jax_h5])
    jax_example("export_h5").main()
    monkeypatch.setattr(sys, "argv", ["weight_sampling.py", "--source", jax_h5, "--dest",
                                      jax_sampled, *sample_args])
    jax_example("weight_sampling").main()

    # The port: the same weights through from_flax_params -> a Trainer
    # checkpoint -> .h5 -> sampled .h5.
    model, _ = ssd_7(SSDConfig.ssd7(n_classes=n_classes, img_height=64, img_width=64),
                     device="cpu")
    model.load_state_dict(from_flax_params(params, stats))
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1), train_step=None)
    trainer.save_checkpoint(str(tmp_path / "port_ckpts"), step=3)
    port_h5, port_sampled = str(tmp_path / "port.h5"), str(tmp_path / "port_sampled.h5")
    export_h5.main(["--model", "ssd7", "--n_classes", str(n_classes), "--img_height", "64",
                    "--img_width", "64", "--checkpoint", str(tmp_path / "port_ckpts"),
                    "--out", port_h5])
    weight_sampling.main(["--source", port_h5, "--dest", port_sampled, *sample_args])

    _assert_same_datasets(port_h5, jax_h5)
    _assert_same_datasets(port_sampled, jax_sampled)
    with h5py.File(port_sampled, "r") as f:
        assert f["classes4"]["classes4"]["kernel:0"].shape[-1] == 3 * 4  # 3 classes, 4 boxes


# ------------------------------------------------------------------------- #
# (v) Every example's main on a tiny export, on the CPU
# ------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthvoc")
    return root, run_workflows_synthvoc.export_synthvoc(str(root), 4, 2, 4)


def _run_main(capsys, main, argv):
    result = main(argv)
    return result, capsys.readouterr().out


@pytest.mark.parametrize("pipeline", ["host_chain", "device_pipeline"])
def test_ssd300_training_main(export, capsys, pipeline):
    root, paths = export
    ckpt, log = root / f"ckpt_{pipeline}", root / f"log_{pipeline}.csv"
    argv = ["--voc_root", paths["voc_root"], "--epochs", "1", "--steps_per_epoch", "2",
            "--batch_size", "2", "--clipnorm", "5", "--base_lr", "1e-4",
            "--checkpoint_dir", str(ckpt), "--csv_log", str(log), *F32]
    if pipeline == "device_pipeline":
        argv += ["--device_pipeline", "--warmup", "2"]
    history, out = _run_main(capsys, ssd300_training.main, argv)
    assert "train: 6  val: 4" in out and "epoch 1/1" in out and "loss=" in out
    assert "loss=nan" not in out and np.isfinite(history["loss"]).all()
    assert sorted(os.listdir(ckpt)) == ["ckpt_0.pt"]
    assert run_workflows_synthvoc.check_training_loss_decreased(str(log), 1.0)("") is None


def test_ssd300_training_data_parallel_one_gloo_rank(export, capsys, monkeypatch):
    """``--data_parallel`` with no launcher environment: one rank of a gloo
    group on the CPU, the resident split gathered through ``exchange_rows``."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    root, paths = export
    history, out = _run_main(capsys, ssd300_training.main, [
        "--voc_root", paths["voc_root"], "--epochs", "1", "--steps_per_epoch", "1",
        "--batch_size", "2", "--clipnorm", "5", "--base_lr", "1e-4", "--device_pipeline",
        "--data_parallel", "--checkpoint_dir", str(root / "ckpt_dp"),
        "--csv_log", str(root / "log_dp.csv"), *F32])
    assert "card-resident train split: 6 images" in out and np.isfinite(history["loss"]).all()
    assert not torch.distributed.is_initialized()


def test_evaluation_coco_and_inference_mains(export, capsys):
    root, paths = export
    ckpt = root / "ckpt_host_chain"
    if not ckpt.exists():
        ssd300_training.main(["--voc_root", paths["voc_root"], "--epochs", "1",
                              "--steps_per_epoch", "1", "--batch_size", "2",
                              "--checkpoint_dir", str(ckpt), "--csv_log", str(root / "l.csv"),
                              *F32])
        capsys.readouterr()
    driver = run_workflows_synthvoc

    mean_ap, out = _run_main(capsys, ssd300_evaluation.main, [
        "--voc_root", paths["voc_root"], "--checkpoint", str(ckpt), "--mode", "training",
        "--batch_size", "2", "--write_results", str(root / "voc_results_"), *F32])
    assert "eval images: 4" in out and "loaded " in out
    assert driver.check_eval_map(0.0)(out) is None and 0.0 <= mean_ap <= 1.0
    assert (root / "voc_results_aeroplane.txt").exists()
    assert "NMS kernel launches: 0" in out  # the plain version on the CPU

    metrics, out = _run_main(capsys, ssd300_evaluation_coco.main, [
        "--images_dir", os.path.join(paths["coco"], "images"),
        "--annotations", os.path.join(paths["coco"], "annotations.json"),
        "--checkpoint", str(ckpt), "--n_classes", "20", "--batch_size", "2",
        "--out_file", str(root / "coco_results.json"), *F32])
    assert driver.check_coco_ap(0.0)(out) is None and set(metrics) >= {"AP", "AP50"}
    assert (root / "coco_results.json").exists()

    images = sorted(os.path.join(paths["img_dir07"], f) for f in os.listdir(paths["img_dir07"]))
    dets, out = _run_main(capsys, ssd300_inference.main,
                          [*images[:2], "--checkpoint", str(ckpt), "--confidence", "0.0", *F32])
    assert dets.shape == (2, 200, 6) and out.count("   class      conf") == 2
    # Every detection is printed where the driver's box check reads it (the
    # boxes of 2 steps of training need not pass its floors).
    assert len(dets[dets[..., 0] > 0]) and driver.check_inference_boxes()(out) != (
        "no detections printed")

    dets, out = _run_main(capsys, ssd512_inference.main,
                          [images[0], "--confidence", "1.1", *F32])
    assert dets.shape == (1, 200, 6) and images[0] + ":" in out
    assert driver.check_inference_boxes()(out) == "no detections printed"
    assert "NMS kernel launches: 0" in out


def test_ssd7_training_main(export, capsys):
    root, paths = export
    history, out = _run_main(capsys, ssd7_training.main, [
        "--images_dir", paths["img_dir07"], "--train_labels", paths["csv"],
        "--img_height", "300", "--img_width", "300", "--n_classes", "20", "--epochs", "2",
        "--steps_per_epoch", "1", "--batch_size", "2", "--checkpoint_dir", str(root / "ckpt7"),
        "--csv_log", str(root / "ssd7_log.csv"), *CPU])
    assert "train images: 4" in out and "final loss:" in out and len(history["loss"]) == 2
    assert "ckpt_0.pt" in os.listdir(root / "ckpt7")  # then only on improvement


def test_synthetic_smoke_main(capsys):
    result, out = _run_main(capsys, synthetic_smoke_ssd300.main, [
        "--steps", "2", "--images", "2", "--batch", "2", *F32])
    assert "recall@0.5 on train set" in out
    assert ("SMOKE PASS" in out) == result["passed"]
    assert result["total"] >= 2 and np.isfinite(result["last_loss"])


def test_synthvoc_benchmark_main(tmp_path, capsys):
    result, out = _run_main(capsys, synthvoc_benchmark.main, [
        "--model", "ssd7", "--steps", "4", "--eval-every", "2", "--train-images", "8",
        "--val-images", "4", "--batch", "4", "--out", str(tmp_path / "out"),
        "--ckpt", str(tmp_path / "ckpt"), *CPU])
    assert out.count("EVAL {") == 2 and "FINAL val mAP sample=" in out
    curve = (tmp_path / "out" / "synthvoc_ssd7_curve.jsonl").read_text().splitlines()
    assert len(curve) == 2 and (tmp_path / "out" / "synthvoc_ssd7_summary.md").exists()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt_2.pt", "ckpt_4.pt"]
    assert 0.0 <= result["map_sample"] <= 1.0 and 0.0 <= result["map_integrate"] <= 1.0

    # --resume picks up at the newest checkpoint and finishes there.
    result, out = _run_main(capsys, synthvoc_benchmark.main, [
        "--model", "ssd7", "--steps", "4", "--eval-every", "2", "--train-images", "8",
        "--val-images", "4", "--batch", "4", "--out", str(tmp_path / "out"),
        "--ckpt", str(tmp_path / "ckpt"), "--resume", *CPU])
    assert "Resumed from step 4" in out and "FINAL val mAP" in out
