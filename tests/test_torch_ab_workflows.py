"""The three accuracy A/B workflows of the port against the JAX package's
scripts, on the CPU.

* ``aug_chain_ab``: its recipe (``synthvoc_benchmark.build_optimizer``, which
  the JAX script imports) equals optax's schedule at every step and its
  updates; its markdown record and printed lines equal the JAX script's on
  the same arm results; ``main`` trains both arms from one init at a tiny
  size and writes the curves and the record; ``--host-workers`` spreads
  the host chain over processes, each over its own rows.
* ``bf16_vs_f32_ssd300``: the schedule and optimizer the JAX script builds
  (captured from its ``main``) equal the port's at every step; the record's
  arithmetic on the JAX package's own record reproduces that record;
  ``main`` runs both arms at a tiny size.
* ``evaluator_decode_agreement``: the record and the verdict equal the JAX
  script's (its ``main`` run with a stand-in model and evaluator) on the
  same per-class APs; ``main`` runs both decode paths on a tiny split from
  a port checkpoint.
"""

import importlib.util
import json
import re
import sys
from argparse import Namespace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssd_keras_torch import SSDConfig, ssd_300
from ssd_keras_torch import train as T
from ssd_keras_torch.examples import aug_chain_ab, bf16_vs_f32_ssd300, evaluator_decode_agreement
from ssd_keras_torch.models import ssd300_predictor_sizes

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
RECORDS = REPO / "docs" / "benchmarks"
CPU = ["--device", "cpu"]
F32 = [*CPU, "--compute_dtype", "float32"]
TINY = ["--steps", "2", "--train-images", "8", "--val-images", "4", "--batch", "2",
        "--warmup", "1"]


def jax_example(name):
    """A JAX package example script as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_ab_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _updates_agree(tx, opt, params, tensors, steps=3, seed=0):
    """``steps`` updates of optax's ``tx`` and the port's ``opt`` from the
    same parameters and clipped gradients agree within 1e-6."""
    rng = np.random.RandomState(seed)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jax_params)
    for _ in range(steps):
        g = {k: (rng.randn(*v.shape) * 3).astype(np.float32) for k, v in params.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, t in tensors.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jax_params[k]),
                                       rtol=0, atol=1e-6, err_msg=k)


def _params(seed=0):
    rng = np.random.RandomState(seed)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    return params, {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}


# ------------------------------------------------------------------------- #
# aug_chain_ab
# ------------------------------------------------------------------------- #


@pytest.mark.parametrize("model, steps, warmup", [("ssd300", 8000, 1000), ("ssd512", 300, 50)])
def test_aug_chain_ab_recipe_equals_optax(model, steps, warmup):
    tx, jax_sched = jax_example("aug_chain_ab").build_optimizer(model, steps, 1e-3, warmup, 5.0)
    params, tensors = _params()
    opt, sched = aug_chain_ab.build_optimizer(model, list(tensors.values()), steps, 1e-3,
                                              warmup, 5.0)
    got = np.array([sched(s) for s in range(steps)])
    want = np.asarray(jax_sched(jnp.arange(steps)), dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    _updates_agree(tx, opt, params, tensors)


def _arm_results():
    rng = np.random.RandomState(3)
    return [{"arm": arm, "final_mAP_sample": float(rng.rand()),
             "final_mAP_integrate": float(rng.rand()), "aps_sample": rng.rand(21).tolist(),
             "init_checksum": 1.0} for arm in ("device", "host")]


def test_aug_chain_ab_record_and_lines_equal_the_jax_scripts(tmp_path, monkeypatch, capsys):
    """Both scripts' ``main`` with their arms stubbed to the same results:
    the same markdown, byte for byte, and the same printed result lines."""
    results = _arm_results()
    jax_mod = jax_example("aug_chain_ab")
    monkeypatch.setattr(jax_mod, "train_arm",
                        lambda arm, *a: dict(next(r for r in results if r["arm"] == arm)))
    monkeypatch.setattr(aug_chain_ab, "train_arm",
                        lambda arm, *a: dict(next(r for r in results if r["arm"] == arm)))
    flags = ["--steps", "6000", "--train-images", "2", "--val-images", "2", "--seed", "1",
             "--warmup", "500", "--peak-lr", "0.002"]
    monkeypatch.setattr(sys, "argv", ["aug_chain_ab.py", *flags, "--out", str(tmp_path / "jax")])
    jax_mod.main()
    jax_out = capsys.readouterr().out
    port = aug_chain_ab.main([*flags, "--out", str(tmp_path / "port"), *F32])
    port_out = capsys.readouterr().out

    def lines(out):  # the timings and the record's path differ
        return [re.sub(r"  -> .*", "", ln) for ln in out.splitlines()
                if "FINAL mAP" in ln or ln.startswith("delta mAP")]

    assert lines(port_out) == lines(jax_out) and len(lines(jax_out)) == 3
    jax_md = (tmp_path / "jax" / "aug_chain_ab.md").read_text()
    port_md = (tmp_path / "port" / "aug_chain_ab.md").read_text()
    assert port_md == jax_md
    assert port["delta"] == pytest.approx(results[0]["final_mAP_sample"]
                                          - results[1]["final_mAP_sample"])


def test_aug_chain_ab_host_workers_take_their_rows_in_turn():
    """``--host-workers 2``: each spawned worker renders the rows ``w::2`` of
    the split the parent renders, and the loader's batches are worker 0's
    and worker 1's in turn, each the chain over its rows seeded
    ``seed * 1000 + w``, as ``chain_batches`` makes them in one process."""
    from ssd_keras_torch.data import SynthVOC

    args = Namespace(seed=3, size=64, batch=2, train_images=8)
    images, labels = SynthVOC(8, 64, split="train", seed=3).materialize()
    shards = aug_chain_ab.ChainShards(args, 16)
    for w in range(2):
        rows, row_labels = shards.rows(w, 2)
        assert np.array_equal(rows, images[w::2])
        assert all(np.array_equal(a, b) for a, b in zip(row_labels, labels[w::2]))
    loader = iter(torch.utils.data.DataLoader(
        shards, batch_size=None, num_workers=2, multiprocessing_context="spawn", timeout=120))
    got = [next(loader) for _ in range(4)]
    del loader
    per_worker = []
    for w in range(2):
        shard = aug_chain_ab.chain_batches(args, 16, images[w::2], labels[w::2], 3 * 1000 + w)
        per_worker.append([next(shard) for _ in range(2)])
    want = [per_worker[i % 2][i // 2] for i in range(4)]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a.numpy(), b)
    assert got[0][0].dtype == torch.uint8 and got[0][0].shape == (2, 64, 64, 3)


def test_aug_chain_ab_main_trains_both_arms_from_one_init(tmp_path, capsys):
    out = aug_chain_ab.main([*TINY, "--eval-every", "2", "--out", str(tmp_path), *F32])
    printed = capsys.readouterr().out
    assert "Rendering SynthVOC 8/4 ..." in printed and printed.count("[EVAL] {") == 2
    assert "[device] FINAL mAP sample=" in printed and "[host] FINAL mAP sample=" in printed
    assert "delta mAP (device - host):" in printed
    device, host = out["results"]
    assert device["init_checksum"] == host["init_checksum"]
    for r in out["results"]:
        assert 0.0 <= r["final_mAP_sample"] <= 1.0 and len(r["aps_sample"]) == 21
    jax_curve_keys = set(json.loads(
        (RECORDS / "aug_chain_ab_device_curve.jsonl").read_text().splitlines()[0]))
    for arm in ("device", "host"):
        rows = [json.loads(ln) for ln in
                (tmp_path / f"aug_chain_ab_{arm}_curve.jsonl").read_text().splitlines()]
        assert [r["step"] for r in rows] == [2] and set(rows[0]) == jax_curve_keys
    assert (tmp_path / "aug_chain_ab.md").exists()


# ------------------------------------------------------------------------- #
# bf16_vs_f32_ssd300
# ------------------------------------------------------------------------- #


class _Captured(Exception):
    pass


def _jax_bf16_recipe(monkeypatch, peak, warmup):
    """The JAX script's schedule and optimizer, captured from its ``main``
    where it hands them to ``create_train_state``."""
    mod = jax_example("bf16_vs_f32_ssd300")
    seen = {}
    sgd = optax.sgd

    def spy_sgd(learning_rate, **kw):
        seen["sched"] = learning_rate
        return sgd(learning_rate=learning_rate, **kw)

    def stop(model, key, x, tx):
        seen["tx"] = tx
        raise _Captured

    monkeypatch.setattr(mod.optax, "sgd", spy_sgd)
    monkeypatch.setattr(mod.T, "create_train_state", stop)
    monkeypatch.setattr(sys, "argv", ["bf16_vs_f32_ssd300.py", "--train-images", "2",
                                      "--val-images", "2", "--peak-lr", str(peak),
                                      "--warmup", str(warmup)])
    with pytest.raises(_Captured):
        mod.main()
    return seen["tx"], seen["sched"]


@pytest.mark.parametrize("peak, warmup", [(1e-3, 400), (2e-3, 37)])
def test_bf16_vs_f32_recipe_equals_the_jax_scripts(monkeypatch, peak, warmup):
    tx, jax_sched = _jax_bf16_recipe(monkeypatch, peak, warmup)
    sched = T.linear_warmup_lr(peak, warmup)  # what the port's main builds
    steps = 2000
    got = np.array([sched(s) for s in range(steps)])
    want = np.asarray(jax_sched(jnp.arange(steps)), dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    params, tensors = _params(1)
    opt = T.sgd_with_momentum(list(tensors.values()), sched, momentum=0.9, clipnorm=5.0)
    _updates_agree(tx, opt, params, tensors)


def _jax_bf16_record():
    """The JAX package's committed record: (record dict, paired rows)."""
    text = (RECORDS / "bf16_vs_f32_ssd300.md").read_text()
    record = json.loads(text.split("```json")[1].split("```")[0])
    rows = [tuple(float(c) for c in ln.strip("|").split("|"))
            for ln in text.splitlines() if re.match(r"\| \d+ \|", ln)]
    return record, rows


def test_bf16_vs_f32_record_arithmetic_reproduces_the_jax_record():
    """The port's record from the JAX run's own losses, mAPs and rates is
    the JAX record, key for key, and its paired table the JAX table."""
    record, rows = _jax_bf16_record()
    runs = {}
    for name, col in (("bf16", 1), ("f32", 2)):
        losses = [{"step": int(r[0]), "loss": r[col]} for r in rows]
        runs[name] = {"losses": losses, "final_loss": losses[-1]["loss"],
                      "val_mAP_sample": record[f"val_mAP_{name}"],
                      "img_per_s": record[f"img_per_s_{name}"]}
    args = Namespace(steps=record["steps"], batch=record["batch"])
    got, paired = bf16_vs_f32_ssd300.paired_record(args, runs)
    assert got == record
    assert [(int(s), lb, lf, d) for s, lb, lf, d in rows] == paired


def test_bf16_vs_f32_main_runs_both_arms(tmp_path, capsys):
    out = bf16_vs_f32_ssd300.main([*TINY, "--out", str(tmp_path / "r.md"), *CPU])
    printed = capsys.readouterr().out
    result = json.loads(next(ln for ln in printed.splitlines()
                             if ln.startswith("RESULT "))[len("RESULT "):])
    assert list(result) == list(_jax_bf16_record()[0])
    assert "[bf16] step     0 loss" in printed and "[f32] step     1 loss" in printed
    assert "[bf16] mAP " in printed and "[f32] mAP " in printed
    # Step 0: the same init and batch; only the compute dtype differs.
    b0, f0 = out["paired"][0][1:3]
    assert np.isfinite([b0, f0]).all() and abs(b0 - f0) <= 0.02 * abs(f0)
    text = (tmp_path / "r.md").read_text()
    assert "| step | loss bf16 | loss f32 | delta |" in text and "TF32 off" in text


# ------------------------------------------------------------------------- #
# evaluator_decode_agreement
# ------------------------------------------------------------------------- #


def _y_pred(batch):
    """A fixed y_pred over SSD300's anchors: softmax scores and small
    offsets, the same for every call."""
    anchors = SSDConfig.ssd300(n_classes=20).anchor_tensor(
        ssd300_predictor_sizes(300, 300)).astype(np.float32)
    rng = np.random.RandomState(0)
    logits = rng.randn(batch, len(anchors), 21).astype(np.float32) * 2.5
    e = np.exp(logits - logits.max(-1, keepdims=True))
    offsets = rng.randn(batch, len(anchors), 4).astype(np.float32) * 0.5
    return np.concatenate([e / e.sum(-1, keepdims=True), offsets,
                           np.broadcast_to(anchors, (batch, len(anchors), 8))], -1)


def _ap_case(kind):
    rng = np.random.RandomState(7)
    dev = rng.uniform(0.3, 0.9, 21)
    host = dev + rng.uniform(-0.004, 0.004, 21)
    if kind == "map_diverges":
        host = dev + 0.006
    elif kind == "class_diverges":
        host = dev.copy()
        host[5] += 0.03
        host[6:9] -= 0.01
    return [0.0, *dev[1:]], [0.0, *host[1:]]


@pytest.mark.parametrize("kind", ["agree", "map_diverges", "class_diverges"])
def test_agreement_record_and_verdict_equal_the_jax_scripts(kind, tmp_path, monkeypatch,
                                                            capsys):
    import orbax.checkpoint as ocp

    mod = jax_example("evaluator_decode_agreement")
    aps = dict(zip((True, False), _ap_case(kind)))
    y = _y_pred(2)

    class Model:
        def apply(self, variables, x):
            return jnp.asarray(y[: x.shape[0]])

    class Evaluator:
        def __init__(self, *args, **kwargs):
            pass

        def predict_on_dataset(self, device_decode, **kwargs):
            self.decode = device_decode

        def get_num_gt_per_class(self, **kwargs):
            pass

        match_predictions = compute_precision_recall = get_num_gt_per_class
        compute_average_precisions = get_num_gt_per_class

        def compute_mean_average_precision(self):
            self.average_precisions = aps[self.decode]
            return float(np.mean(aps[self.decode][1:]))

    ckpt = tmp_path / "ckpts"
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(str(ckpt / "ckpt_1"), {"params": {"w": np.zeros(2, np.float32)}})
    checkpointer.wait_until_finished()
    monkeypatch.setattr(mod, "ssd_300", lambda cfg, compute_dtype: (Model(), None))
    monkeypatch.setattr(mod, "Evaluator", Evaluator)
    monkeypatch.setattr(sys, "argv", ["evaluator_decode_agreement.py", "--ckpt", str(ckpt),
                                      "--images", "4", "--batch", "2", "--out",
                                      str(tmp_path / "jax.md")])
    status = mod.main()
    printed = capsys.readouterr().out
    jax_record = json.loads(next(ln for ln in printed.splitlines()
                                 if ln.startswith("RESULT "))[len("RESULT "):])

    eligible = {k: jax_record[k] for k in jax_record if k.startswith("eligible_")}
    runs = {d: {"mAP": float(np.mean(aps[d][1:])), "aps": aps[d],
                "img_per_s": jax_record["device_img_per_s" if d else "host_img_per_s"]}
            for d in (True, False)}
    record, ok = evaluator_decode_agreement.agreement(runs[True], runs[False], 4, 0, eligible)
    assert record == jax_record
    assert ok == (status == 0) == ("AGREEMENT OK" in printed) == (kind == "agree")


def test_agreement_main_on_a_port_checkpoint(tmp_path, capsys):
    model, _ = ssd_300(SSDConfig.ssd300(n_classes=20), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.conv1_1.weight.mul_(0.01)
    T.Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1), train_step=None
              ).save_checkpoint(str(tmp_path / "ckpts"), step=3)
    out = evaluator_decode_agreement.main([
        "--ckpt", str(tmp_path / "ckpts"), "--images", "4", "--batch", "2",
        "--out", str(tmp_path / "agreement.md"), *F32])
    printed = capsys.readouterr().out
    assert "restored ckpt_3.pt" in printed and "eligible-box stats:" in printed
    assert "device_decode=True: mAP" in printed and "device_decode=False: mAP" in printed
    result = json.loads(next(ln for ln in printed.splitlines()
                             if ln.startswith("RESULT "))[len("RESULT "):])
    assert result == out["record"] and result["images"] == 4
    assert ("AGREEMENT OK" in printed) == out["ok"]
    assert (tmp_path / "agreement.md").exists()
    for path in (True, False):
        assert 0.0 <= out["results"][path]["mAP"] <= 1.0
