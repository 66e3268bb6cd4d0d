"""The port's training step, optimizers, callbacks and Trainer against the
JAX package's, on SSD7 at 64x64 (its own training-test model) with f32
compute.

Weights come from flax ``init`` through ``create_train_state`` and reach the
port with ``weights_io.from_flax_params``; ``y_true`` is encoder-made (the
port's encoder, equal to the JAX encoder's: tests/test_torch_encoder.py).
The JAX model runs its plain conv1 (``s2d_trunk=False``), the port's form.

Tolerances:

* losses within ``LOSS_RTOL`` = 1e-5 relative: XLA and PyTorch sum the
  convolutions, BatchNorm and loss in other orders (~3e-7 seen).
* BatchNorm running statistics within ``STATS_TOL`` = 1e-3 of each layer's
  largest entry (~4e-6 after one step, ~4e-5 after two, seen).
* Parameters after a step of ``make_train_step``, the jitted JAX step,
  within ``JIT_PARAM_TOL`` = 2e-2 of the step's largest update. flax's
  BatchNorm variance is ``E[x^2] - E[x]^2``, which cancels in f32 where the
  activations have a large mean; XLA's jitted step sums those reductions in
  another order than its own eager ops, and that moves the conv1-conv3
  kernel gradients by up to 0.6% of the largest gradient (jit against eager
  JAX, seen). The port agrees with eager JAX to ~1e-5.
* So the tight check of the update runs against the JAX package's own
  optimizer chain (``sgd_with_momentum``, ``adam``) applied to the eager JAX
  gradient of the same loss: parameters within ``EAGER_PARAM_TOL`` = 1e-2
  of the largest update (SGD, ~1e-3 seen with the clip binding) or of lr
  (Adam, ~2e-4 seen).

Adam's first step is ``lr * g / (|g| + eps)``, about ``lr * sign(g)``, so an
entry whose gradient is within rounding of 0 on both sides may step either
way by a full lr. That is every conv bias of SSD7 (each feeds a BatchNorm,
which removes it, so its true gradient is 0) and the taps of the heads that
only ever see padding. The Adam check leaves out the entries whose eager
gradient is below ``1e-4`` of the largest, about a fifth of them, and runs
one step: after a second, those entries have moved the rest.
"""

import csv
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssd_keras_tpu import train as jax_train
from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.loss import SSDLoss as JaxSSDLoss
from ssd_keras_tpu.models import ssd_7 as jax_ssd_7
from ssd_keras_torch import train as T
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.encoder import SSDInputEncoder
from ssd_keras_torch.loss import SSDLoss
from ssd_keras_torch.models import ssd_7
from ssd_keras_torch.weights_io import from_flax_params, to_flax_params

torch.set_num_threads(2)

LR = 1e-3
L2 = 5e-4
LOSS_RTOL = 1e-5
STATS_TOL = 1e-3
JIT_PARAM_TOL = 2e-2
EAGER_PARAM_TOL = 1e-2
ADAM_GRAD_FLOOR = 1e-4
KW = dict(n_classes=3, img_height=64, img_width=64)


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _labels(rng, batch):
    out = []
    for _ in range(batch):
        k = rng.randint(1, 5)
        wh = rng.uniform(8, 40, (k, 2))
        xy = rng.uniform(0, 1, (k, 2)) * (64 - wh)
        out.append(np.concatenate([rng.randint(1, 4, (k, 1)), xy, xy + wh], axis=1))
    return out


@pytest.fixture(scope="module")
def setup():
    """(flax SSD7, two encoder-made batches of 4)."""
    jax_model, sizes = jax_ssd_7(JaxSSDConfig.ssd7(**KW), s2d_trunk=False)
    encoder = SSDInputEncoder(SSDConfig.ssd7(**KW), sizes, max_gt_boxes=8, device="cpu")
    rng = np.random.RandomState(0)
    batches = [(rng.rand(4, 64, 64, 3).astype(np.float32) * 255, encoder(_labels(rng, 4)))
               for _ in range(2)]
    return jax_model, batches


def _jax_state(jax_model, batches, tx):
    return jax_train.create_train_state(jax_model, jax.random.PRNGKey(0), batches[0][0], tx)


def _port_model(state, compute_dtype=torch.float32):
    model, _ = ssd_7(SSDConfig.ssd7(**KW), compute_dtype=compute_dtype, device="cpu")
    model.load_state_dict(from_flax_params(_tree(state.params), _tree(state.batch_stats)))
    return model


def _grad_norm(model, x, y):
    """Global norm of the gradient of the training loss (data loss + L2)."""
    model.train()
    loss = SSDLoss()(torch.from_numpy(y), model(torch.from_numpy(x)))
    loss = loss + T.l2_penalty(T.conv_kernels(model), L2)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])))


OPTIMIZERS = {
    "sgd": (lambda clip: jax_train.sgd_with_momentum(LR, 0.9, clipnorm=clip),
            lambda params, clip: T.sgd_with_momentum(params, LR, 0.9, clipnorm=clip)),
    "adam": (lambda clip: jax_train.adam(LR, clipnorm=clip),
             lambda params, clip: T.adam(params, LR, clipnorm=clip)),
}


def _assert_metrics_and_stats(got, expected, model, state):
    for key in ("loss", "data_loss"):
        np.testing.assert_allclose(float(got[key]), float(expected[key]), rtol=LOSS_RTOL)
    _, got_stats = to_flax_params(model.state_dict())
    for layer, tensors in _tree(state.batch_stats).items():
        for key, value in tensors.items():
            np.testing.assert_allclose(got_stats[layer][key], value, rtol=0,
                                       atol=STATS_TOL * np.abs(value).max(),
                                       err_msg=f"{layer}/{key}")


def _assert_params_close(model, expected, atol, mask=None):
    got, _ = to_flax_params(model.state_dict())
    for layer, tensors in expected.items():
        for key, value in tensors.items():
            keep = np.ones(value.shape, bool) if mask is None else mask[layer][key]
            np.testing.assert_allclose(got[layer][key][keep], value[keep], rtol=0, atol=atol,
                                       err_msg=f"{layer}/{key}")


def _largest_update(after, before):
    return max(np.abs(after[l][k] - before[l][k]).max() for l in after for k in after[l])


@pytest.mark.parametrize("kind, clipnorm", [("sgd", None), ("sgd", 1.0), ("adam", None), ("adam", 1.0)])
def test_train_steps_equal_jax_train_step(setup, kind, clipnorm):
    """Loss and BatchNorm statistics against ``make_train_step``; SGD's
    parameters too, over two steps (Adam's: the next test)."""
    jax_model, batches = setup
    jax_tx, port_opt = OPTIMIZERS[kind]
    state = _jax_state(jax_model, batches, jax_tx(clipnorm))
    jax_step = jax_train.make_train_step(jax_model, JaxSSDLoss(), l2_reg=L2, donate=False)
    model = _port_model(state)
    step = T.make_train_step(model, port_opt(model.parameters(), clipnorm), SSDLoss(), l2_reg=L2)
    if clipnorm is not None:  # the clip binds
        assert _grad_norm(_port_model(state), *batches[0]) > 10 * clipnorm
    for x, y in batches[: 2 if kind == "sgd" else 1]:
        before = _tree(state.params)
        state, expected = jax_step(state, jnp.asarray(x), jnp.asarray(y))
        got = step(torch.from_numpy(x), torch.from_numpy(y))
        _assert_metrics_and_stats(got, expected, model, state)
        if kind == "sgd":
            after = _tree(state.params)
            _assert_params_close(model, after, JIT_PARAM_TOL * _largest_update(after, before))
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("kind, clipnorm", [("sgd", None), ("sgd", 1.0), ("adam", None), ("adam", 1.0)])
def test_update_equals_jax_optimizer_on_eager_gradient(setup, kind, clipnorm):
    jax_model, batches = setup
    jax_tx, port_opt = OPTIMIZERS[kind]
    tx = jax_tx(clipnorm)
    state = _jax_state(jax_model, batches, tx)
    params, opt_state = state.params, tx.init(state.params)
    model = _port_model(state)
    step = T.make_train_step(model, port_opt(model.parameters(), clipnorm), SSDLoss(), l2_reg=L2)
    for x, y in batches[: 2 if kind == "sgd" else 1]:
        def loss_fn(p):  # make_train_step's loss, not jitted
            y_pred, mutated = jax_model.apply(
                {"params": p, "batch_stats": state.batch_stats}, jnp.asarray(x), train=True,
                mutable=["batch_stats"])
            data_loss = JaxSSDLoss()(jnp.asarray(y), y_pred)
            return data_loss + jax_train._l2_penalty(p, L2), mutated["batch_stats"]

        grads, stats = jax.grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        before = _tree(params)
        params = optax.apply_updates(params, updates)
        state = state.replace(params=params, batch_stats=stats)
        step(torch.from_numpy(x), torch.from_numpy(y))
        after = _tree(params)
        if kind == "sgd":
            _assert_params_close(model, after, EAGER_PARAM_TOL * _largest_update(after, before))
        else:
            g = _tree(grads)
            floor = ADAM_GRAD_FLOOR * max(np.abs(v).max() for t in g.values() for v in t.values())
            mask = {l: {k: np.abs(v) >= floor for k, v in t.items()} for l, t in g.items()}
            _assert_params_close(model, after, EAGER_PARAM_TOL * LR, mask)


def test_l2_penalty_equals_jax(setup):
    """``l2_reg * sum(kernel**2)`` over the conv kernels only: 7 trunk and 8
    head convolutions, no bias and no BatchNorm scale."""
    jax_model, batches = setup
    state = _jax_state(jax_model, batches, optax.sgd(LR))
    model = _port_model(state)
    kernels = T.conv_kernels(model)
    assert len(kernels) == 15 and all(k.dim() == 4 for k in kernels)
    with torch.no_grad():
        got = float(T.l2_penalty(kernels, L2))
    np.testing.assert_allclose(got, float(jax_train._l2_penalty(state.params, L2)), rtol=1e-6)
    assert T.l2_penalty(kernels, 0.0) == 0.0


# ---------------------------------------------------------------------------
# Optimizer pieces against optax, on a small parameter vector
# ---------------------------------------------------------------------------


def test_piecewise_lr_equals_optax():
    for kwargs in ({}, {"base_lr": 1e-4, "boundaries_and_scales": {3: 0.5, 7: 0.1}}):
        got, expected = T.piecewise_lr(**kwargs), jax_train.piecewise_lr(**kwargs)
        for step in (0, 2, 3, 6, 7, 79_999, 80_000, 99_999, 100_000, 200_000):
            assert got(step) == pytest.approx(float(expected(step)), rel=1e-6)


def test_linear_warmup_equals_the_examples_schedule():
    """The warmup ``examples/ssd300_training.py`` joins from optax pieces."""
    base, warmup = 1e-4, 10
    expected = optax.join_schedules(
        [optax.linear_schedule(base * 0.01, base, warmup), optax.constant_schedule(base)],
        boundaries=[warmup])
    got = T.linear_warmup_lr(base, warmup)
    for step in range(15):
        assert got(step) == pytest.approx(float(expected(step)), rel=1e-6)


@pytest.mark.parametrize("max_norm", [100.0, 2.0])
def test_clip_by_global_norm_equals_optax(max_norm):
    rng = np.random.RandomState(3)
    grads = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    expected, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    T.clip_by_global_norm_(got, max_norm)
    for g, e, orig in zip(got, expected, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-6)
        if max_norm == 100.0:  # below the norm: untouched, no epsilon
            np.testing.assert_array_equal(g.numpy(), orig)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_scheduled_clipped_optimizer_equals_optax(kind):
    """Four updates with a warmup schedule and a binding clip: the torch
    optimizer and the JAX package's optax chain move the same parameters."""
    rng = np.random.RandomState(4)
    p0 = rng.randn(6).astype(np.float32)
    grads = [rng.randn(6).astype(np.float32) * 3 for _ in range(4)]
    schedule = T.linear_warmup_lr(1e-2, 3)
    jax_schedule = optax.join_schedules(
        [optax.linear_schedule(1e-4, 1e-2, 3), optax.constant_schedule(1e-2)], boundaries=[3])
    if kind == "sgd":
        tx = jax_train.sgd_with_momentum(jax_schedule, 0.9, clipnorm=2.0)
        param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = T.sgd_with_momentum([param], schedule, 0.9, clipnorm=2.0)
    else:
        tx = jax_train.adam(jax_schedule, clipnorm=2.0)
        param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = T.adam([param], schedule, clipnorm=2.0)
    params, opt_state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(params), rtol=1e-5, atol=1e-7)
    assert opt.param_groups[0]["count"] == 4


# ---------------------------------------------------------------------------
# Trainer and callbacks (the behaviours tests/test_train.py holds for JAX)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def toy():
    """A batch generator with one positive per image, as tests/test_train.py
    builds it, and the SSD7 anchor count."""
    cfg = SSDConfig.ssd7(**KW)
    n = 340
    c = cfg.n_classes_with_background

    def gen(seed=0):
        rng = np.random.RandomState(seed)
        while True:
            images = rng.rand(4, 64, 64, 3).astype(np.float32) * 255
            y = np.zeros((4, n, c + 12), np.float32)
            y[:, :, 0] = 1.0
            for b in range(4):
                y[b, 13 * b, 0] = 0.0
                y[b, 13 * b, 1 + b % 3] = 1.0
            yield images, y

    return gen


def _trainer(compute_dtype=torch.float32, lr=1e-3):
    model, _ = ssd_7(SSDConfig.ssd7(**KW), compute_dtype=compute_dtype,
                     generator=torch.Generator().manual_seed(0), device="cpu")
    opt = T.sgd_with_momentum(model.parameters(), lr)
    step = T.make_train_step(model, opt, SSDLoss(), l2_reg=1e-4)
    return T.Trainer(model, opt, step, T.make_eval_step(model, SSDLoss()), base_lr=1e-3)


def _lr(trainer):
    return trainer.optimizer.param_groups[0]["lr"]


def test_fit_generator_runs_and_logs(toy, tmp_path):
    trainer = _trainer()
    csv_path = str(tmp_path / "log.csv")
    history = trainer.fit_generator(
        toy(), steps_per_epoch=3, epochs=2, callbacks=[T.CSVLogger(csv_path), T.TerminateOnNaN()],
        val_generator=toy(1), validation_steps=1, verbose=False)
    assert len(history["loss"]) == len(history["val_loss"]) == 2
    assert all(math.isfinite(v) for v in history["loss"] + history["val_loss"])
    assert trainer.step == 6
    lines = open(csv_path).read().strip().splitlines()
    assert lines[0] == "epoch,loss,val_loss" and len(lines) == 3


def test_csv_logger_append_semantics(toy, tmp_path):
    """``append=False`` truncates a file from an earlier run, ``append=True``
    continues it without a second header."""
    csv_path = str(tmp_path / "log.csv")
    with open(csv_path, "w") as f:
        f.write("epoch,loss,val_loss\n0,nan,nan\n")
    trainer = _trainer()
    trainer.fit_generator(toy(), steps_per_epoch=1, epochs=1, verbose=False,
                          callbacks=[T.CSVLogger(csv_path, append=False)])
    lines = open(csv_path).read().strip().splitlines()
    assert lines[0] == "epoch,loss" and len(lines) == 2 and "nan" not in lines[1]
    trainer.fit_generator(toy(), steps_per_epoch=1, epochs=1, verbose=False,
                          callbacks=[T.CSVLogger(csv_path, append=True)])
    lines = open(csv_path).read().strip().splitlines()
    assert lines.count("epoch,loss") == 1 and len(lines) == 3


def test_csv_logger_tolerates_changing_metric_keys(tmp_path):
    csv_path = str(tmp_path / "log.csv")
    logger = T.CSVLogger(csv_path)
    logger.on_epoch_end(0, {"loss": 1.0}, None)
    logger.on_epoch_end(1, {"loss": 0.5, "val_loss": 0.7}, None)  # a new key: dropped
    logger.on_epoch_end(2, {}, None)  # a missing key: empty column
    lines = open(csv_path).read().strip().splitlines()
    assert lines == ["epoch,loss", "0,1.0", "1,0.5", "2,"]
    assert [r["epoch"] for r in csv.DictReader(open(csv_path))] == ["0", "1", "2"]


def test_lr_schedule_sets_param_group_lr(toy):
    trainer = _trainer()
    trainer.fit_generator(toy(), steps_per_epoch=1, epochs=2, base_lr=1e-3, verbose=False,
                          lr_schedule=lambda epoch: 1e-3 if epoch < 1 else 1e-5)
    assert _lr(trainer) == pytest.approx(1e-5)
    assert trainer.lr_scale == pytest.approx(1e-2)


def test_lr_scheduler_applies_schedule0_at_epoch0(toy):
    trainer = _trainer()
    seen = []

    class SpyLR(T.Callback):
        def on_epoch_end(self, epoch, logs, tr):
            seen.append(_lr(tr))

    warmup = T.LearningRateScheduler(schedule=lambda e: 1e-6 if e == 0 else 1e-3, base_lr=1e-3)
    trainer.fit_generator(toy(), steps_per_epoch=1, epochs=2, callbacks=[warmup, SpyLR()],
                          verbose=False)
    assert seen == [pytest.approx(1e-6), pytest.approx(1e-3)]


def test_set_lr_keeps_momentum_buffers(toy):
    trainer = _trainer()
    trainer.fit_generator(toy(), steps_per_epoch=2, epochs=1, verbose=False)
    buffers = {id(p): s["momentum_buffer"].clone() for p, s in trainer.optimizer.state.items()}
    assert len(buffers) == len(list(trainer.module.parameters()))
    trainer.set_lr(5e-4)
    assert all(g["lr"] == 5e-4 for g in trainer.optimizer.param_groups)
    for p, s in trainer.optimizer.state.items():
        assert torch.equal(s["momentum_buffer"], buffers[id(p)])
    images, y = next(toy())
    assert torch.isfinite(trainer.train_step(torch.from_numpy(images), torch.from_numpy(y))["loss"])


def test_reduce_lr_on_plateau_and_early_stopping(toy):
    trainer = _trainer()
    plateau = T.ReduceLROnPlateau(monitor="loss", factor=0.1, patience=1, min_lr_scale=5e-3)
    never_better = T.EarlyStopping(monitor="loss", patience=1, min_delta=1e9)
    history = trainer.fit_generator(toy(), steps_per_epoch=1, epochs=10, verbose=False,
                                    callbacks=[plateau, never_better])
    assert len(history["loss"]) == 2  # the first epoch sets the best, the second stops
    for logs in ({"loss": 1e9}, {"loss": 1e9}, {"loss": 1e9}):
        plateau.on_epoch_end(0, logs, trainer)
    assert trainer.lr_scale == pytest.approx(5e-3)  # floored at min_lr_scale
    assert _lr(trainer) == pytest.approx(5e-6)


def test_terminate_on_nan(toy):
    trainer = _trainer()

    class PoisonLoss(T.Callback):
        def on_epoch_end(self, epoch, logs, tr):
            logs["loss"] = math.nan
            T.TerminateOnNaN().on_epoch_end(epoch, logs, tr)

    history = trainer.fit_generator(toy(), steps_per_epoch=1, epochs=5, callbacks=[PoisonLoss()],
                                    verbose=False)
    assert len(history["loss"]) == 1 and trainer.terminated_on_nan


def test_model_checkpoint_saves_on_improvement(toy, tmp_path):
    trainer = _trainer()
    ckpt = T.ModelCheckpoint(str(tmp_path), monitor="loss", save_best_only=True)
    for epoch, loss in enumerate([3.0, 4.0, 2.0]):
        ckpt.on_epoch_end(epoch, {"loss": loss}, trainer)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_0.pt", "ckpt_2.pt"]


def test_checkpoint_round_trip(toy, tmp_path):
    """``torch.save`` of model, optimizer and step count: restoring rolls
    parameters, momentum and BN statistics back, and the next step from the
    restored state equals the next step from the saved one."""
    trainer = _trainer()
    batches = [tuple(torch.from_numpy(a) for a in b) for b, _ in zip(toy(), range(3))]
    for images, y in batches[:2]:
        trainer.train_step(images, y)
        trainer.step += 1
    path = trainer.save_checkpoint(str(tmp_path), step=7)
    assert os.path.basename(path) == "ckpt_7.pt"
    saved = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    trainer.train_step(*batches[2])
    after_one = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    assert not torch.equal(after_one["conv1.weight"], saved["conv1.weight"])

    fresh = _trainer()
    fresh.restore_checkpoint(path)
    assert fresh.step == 2
    for k, v in fresh.module.state_dict().items():
        assert torch.equal(v, saved[k]), k
    fresh.train_step(*batches[2])
    for k, v in fresh.module.state_dict().items():
        assert torch.equal(v, after_one[k]), k


def test_prepare_keeps_device_batches(toy):
    trainer = _trainer()
    images_np, y_np = next(toy())
    images, y = torch.from_numpy(images_np), torch.from_numpy(y_np)
    pi, py = trainer._prepare(images, y)
    assert pi is images and py is y
    hi, hy = trainer._prepare(images_np, y_np)
    assert torch.equal(hi, images) and torch.equal(hy, y)


def test_bf16_training_keeps_f32_params_and_tracks_f32(toy):
    """bf16 compute over f32 master weights against f32, same weights and
    data, 30 SGD steps: the trajectories stay within 15% and both train (the
    JAX package holds its bf16 recipe to the same bounds)."""
    batches = [tuple(torch.from_numpy(a) for a in b) for b, _ in zip(toy(), range(10))]

    def run(dtype):
        trainer = _trainer(dtype)
        losses = [float(trainer.train_step(*batches[i % 10])["loss"]) for i in range(30)]
        assert all(p.dtype == torch.float32 for p in trainer.module.parameters())
        assert all(b.dtype == torch.float32 for b in trainer.module.buffers())
        return np.asarray(losses)

    l32, l16 = run(torch.float32), run(torch.bfloat16)
    assert np.all(np.isfinite(l16))
    assert abs(l16[0] - l32[0]) / l32[0] < 0.02
    np.testing.assert_allclose(l16, l32, rtol=0.15)
    assert l16[-1] < 0.7 * l16[0] and l32[-1] < 0.7 * l32[0]
