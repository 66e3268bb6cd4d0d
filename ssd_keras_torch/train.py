"""Training loop: optimizers, the train step, callbacks, checkpoints (PyTorch).

Port of ``ssd_keras_tpu/train.py`` (the reference's ``model.compile`` +
``fit_generator`` workflow with ModelCheckpoint / CSVLogger /
LearningRateScheduler / TerminateOnNaN / EarlyStopping / ReduceLROnPlateau).

* The optimizers are ``torch.optim.SGD`` and ``torch.optim.Adam`` with what
  the JAX package chains around optax's: global-norm clipping that follows
  ``optax.clip_by_global_norm`` and a learning rate that may be a per-step
  schedule, as ``optax.inject_hyperparams`` evaluates it.
* :func:`make_train_step` runs forward, loss (hard negative mining on the
  device), the Keras-style kernel L2 penalty, backward, clipping and the
  update, and returns device scalars: it makes the host wait for nothing.
* Parameters stay f32 under any compute dtype (``models/common.py``).
* Checkpoints are ``torch.save`` files of the model, the optimizer and the
  step count. The Trainer reads losses on the host once per epoch.
* Data parallelism (``mesh``, ``parallel/sharding.py:make_mesh``): each rank
  steps on its rows of the global batch, and the step stays the global
  batch's, as the JAX package's jit over global arrays makes it: the loss
  is normalised and mined over the global batch (``SSDLoss.local_term``),
  BatchNorm takes global statistics, the gradients are summed over the
  ranks before the clip and the update, the L2 term counts once, and the
  metrics are the global loss. Rank 0 writes checkpoints and logs.
"""

from __future__ import annotations

import csv
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ssd_keras_torch.loss import SSDLoss
from ssd_keras_torch.models.layers import batch_statistics_over
from ssd_keras_torch.parallel.sharding import mesh_group
from ssd_keras_torch.utils.profiling import count, span

__all__ = [
    "SGD",
    "Adam",
    "sgd_with_momentum",
    "adam",
    "piecewise_lr",
    "linear_warmup_lr",
    "clip_by_global_norm_",
    "conv_kernels",
    "l2_penalty",
    "make_train_step",
    "make_eval_step",
    "all_reduce_gradients",
    "Callback",
    "ModelCheckpoint",
    "CSVLogger",
    "LearningRateScheduler",
    "TerminateOnNaN",
    "EarlyStopping",
    "ReduceLROnPlateau",
    "Trainer",
    "fit_generator",
]

Schedule = Callable[[int], float]


def clip_by_global_norm_(tensors: Sequence[torch.Tensor], max_norm: float) -> None:
    """Scale ``tensors`` in place by ``max_norm / g_norm`` when their global
    norm ``g_norm >= max_norm`` (``optax.clip_by_global_norm``; unlike
    ``clip_grad_norm_`` there is no epsilon). Device ops only, no host read."""
    if not tensors:
        return
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))
    scale = torch.where(g_norm < max_norm, 1.0, max_norm / g_norm)
    torch._foreach_mul_(list(tensors), scale)


class _OptaxChain:
    """Adds to a torch optimizer what the JAX package's optax chain has:
    ``clip_by_global_norm(clipnorm)`` before the update, and a learning rate
    that may be a schedule ``step -> lr``, evaluated before update ``k`` with
    ``k`` (``inject_hyperparams``). The update count lives in each param
    group as ``"count"``, so the optimizer's ``state_dict`` carries it.
    Setting a group's ``"lr"`` changes the rate and leaves the momentum or
    moment buffers as they are; with a schedule, the next update sets it
    again, as optax does."""

    def __init__(self, params, learning_rate: Union[float, Schedule],
                 clipnorm: Optional[float] = None, **kwargs):
        self.lr_schedule = learning_rate if callable(learning_rate) else None
        lr = learning_rate(0) if self.lr_schedule else learning_rate
        super().__init__(params, lr=lr, **kwargs)
        self.clipnorm = clipnorm
        for group in self.param_groups:
            group.setdefault("count", 0)

    @torch.no_grad()
    def step(self, closure=None):
        if self.clipnorm is not None:
            grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
            clip_by_global_norm_(grads, self.clipnorm)
        for group in self.param_groups:
            if self.lr_schedule is not None:
                group["lr"] = float(self.lr_schedule(group["count"]))
            group["count"] += 1
        return super().step(closure)


class SGD(_OptaxChain, torch.optim.SGD):
    """``torch.optim.SGD`` with the optax chain's clipping and schedule."""


class Adam(_OptaxChain, torch.optim.Adam):
    """``torch.optim.Adam`` with the optax chain's clipping and schedule."""


def sgd_with_momentum(params, learning_rate: Union[float, Schedule] = 1e-3,
                      momentum: float = 0.9, clipnorm: Optional[float] = None) -> SGD:
    """The canonical SSD optimizer (ssd300_training.ipynb cell 7). optax
    ``sgd(momentum)`` is ``torch.optim.SGD`` with no dampening, no Nesterov
    and no weight decay (the L2 term is part of the loss)."""
    return SGD(params, learning_rate, clipnorm, momentum=momentum, dampening=0.0,
               nesterov=False, weight_decay=0.0)


def adam(params, learning_rate: Union[float, Schedule] = 1e-3,
         clipnorm: Optional[float] = None, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Adam:
    """SSD7's optimizer (ssd7_training.ipynb cell 7); optax's ``b1``, ``b2``
    and ``eps`` are ``betas`` and ``eps`` here."""
    return Adam(params, learning_rate, clipnorm, betas=(b1, b2), eps=eps, weight_decay=0.0)


def piecewise_lr(base_lr: float = 1e-3, boundaries_and_scales: Optional[Dict[int, float]] = None
                 ) -> Schedule:
    """Step schedule (``optax.piecewise_constant_schedule``): ``base_lr``
    times every scale whose boundary the step has reached. The default
    mirrors the SSD300 drops at 80k and 100k steps."""
    if boundaries_and_scales is None:
        boundaries_and_scales = {80_000: 0.1, 100_000: 0.1}
    bounds = sorted(boundaries_and_scales.items())

    def schedule(step: int) -> float:
        lr = base_lr
        for boundary, scale in bounds:
            if step >= boundary:
                lr *= scale
        return lr

    return schedule


def linear_warmup_lr(base_lr: float, warmup_steps: int, start_factor: float = 0.01) -> Schedule:
    """Linear warmup from ``start_factor * base_lr`` to ``base_lr`` over
    ``warmup_steps``, then constant: the schedule that
    ``examples/ssd300_training.py`` builds with optax's ``join_schedules``
    of a ``linear_schedule`` and a ``constant_schedule``."""
    start = base_lr * start_factor

    def schedule(step: int) -> float:
        if step >= warmup_steps:
            return base_lr
        frac = 1.0 - step / warmup_steps
        return (start - base_lr) * frac + base_lr

    return schedule


def conv_kernels(module: nn.Module) -> List[torch.Tensor]:
    """The convolution weights of ``module``: what the L2 penalty covers."""
    return [m.weight for m in module.modules() if isinstance(m, nn.Conv2d)]


def l2_penalty(kernels: Sequence[torch.Tensor], l2_reg: float):
    """Keras-style kernel L2 regularisation: ``l2_reg * sum(kernel**2)`` over
    convolution weights only (no biases, BatchNorm scales or the
    L2Normalization gamma), the term the reference's ``l2(l2_reg)`` adds to
    the training loss."""
    if l2_reg == 0.0:
        return 0.0
    return l2_reg * sum(w.square().sum() for w in kernels)


def all_reduce_gradients(params: Sequence[torch.Tensor], group) -> None:
    """Sum the gradients of ``params`` over the ranks of ``group`` in place,
    in one flat all-reduce (a parameter with no gradient contributes 0)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        if p.grad is None:
            p.grad = g.view_as(p).clone()
        else:
            p.grad.copy_(g.view_as(p))


def make_train_step(module: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_obj: Optional[SSDLoss] = None, l2_reg: float = 0.0, mesh=None):
    """Build ``train_step(images, y_true) -> {"loss", "data_loss"}``.

    One call runs the forward pass (BatchNorm on batch statistics), the SSD
    loss, the L2 penalty, backward, the optimizer's clipping and update, and
    ``zero_grad(set_to_none=True)``. The metrics are device scalars: nothing
    is read on the host.

    With ``mesh``, every rank calls the step on its rows of the global
    batch (``parallel.sharding.shard_batch``) with equal parameters
    (``parallel.sharding.replicate``). Each rank backpropagates its term of
    the global loss (its items over the global positive count, and 1/n of
    the L2 term), the gradients are summed over the ranks, and the metrics
    are summed too: every rank returns the global loss and takes the same
    update.
    """
    loss_obj = loss_obj or SSDLoss()
    kernels = conv_kernels(module)
    group = None if mesh is None else mesh_group(mesh)
    world = 1 if group is None else dist.get_world_size(group)
    params = [p for p in module.parameters() if p.requires_grad]

    def train_step(images: torch.Tensor, y_true: torch.Tensor) -> Dict[str, torch.Tensor]:
        module.train()
        with span("train.forward"), batch_statistics_over(group):
            y_pred = module(images)
        with span("train.loss"):
            if group is None:
                data_loss = loss_obj.compute_loss(y_true, y_pred).mean()
                loss = data_loss + l2_penalty(kernels, l2_reg)
            else:
                data_loss = loss_obj.local_term(y_true, y_pred, group)
                loss = data_loss + l2_penalty(kernels, l2_reg / world)
        with span("train.backward"):
            loss.backward()
            if group is not None:
                all_reduce_gradients(params, group)
        with span("train.optimizer"):
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        metrics = torch.stack([loss.detach(), data_loss.detach()])
        if group is not None:
            dist.all_reduce(metrics, group=group)
        return {"loss": metrics[0], "data_loss": metrics[1]}

    return train_step


def make_eval_step(module: nn.Module, loss_obj: Optional[SSDLoss] = None, mesh=None):
    """Build ``eval_step(images, y_true) -> loss`` (a device scalar), with
    BatchNorm on its running statistics. With ``mesh``, each rank passes
    its rows of the global batch and gets the global batch's loss."""
    loss_obj = loss_obj or SSDLoss()
    group = None if mesh is None else mesh_group(mesh)

    @torch.no_grad()
    def eval_step(images: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        module.eval()
        y_pred = module(images)
        if group is None:
            return loss_obj.compute_loss(y_true, y_pred).mean()
        loss = loss_obj.local_term(y_true, y_pred, group)
        dist.all_reduce(loss, group=group)
        return loss

    return eval_step


# --------------------------------------------------------------------------- #
# Callbacks (Keras semantics, as in the JAX package)
# --------------------------------------------------------------------------- #


class Callback:
    def on_epoch_begin(self, epoch: int, logs: Dict[str, float], trainer) -> None:
        pass

    def on_epoch_end(self, epoch: int, logs: Dict[str, float], trainer) -> None:
        pass


class ModelCheckpoint(Callback):
    """Save a checkpoint each epoch; optionally only on improvement."""

    def __init__(self, directory, monitor="val_loss", save_best_only=True, mode="min"):
        self.directory = os.path.abspath(directory)
        self.monitor = monitor
        self.save_best_only = save_best_only
        self.best = math.inf if mode == "min" else -math.inf
        self.mode = mode

    def on_epoch_end(self, epoch, logs, trainer):
        value = logs.get(self.monitor)
        if self.save_best_only and value is not None:
            improved = value < self.best if self.mode == "min" else value > self.best
            if not improved:
                return
            self.best = value
        trainer.save_checkpoint(self.directory, step=epoch)


class CSVLogger(Callback):
    """Per-epoch metrics to a CSV file (Keras semantics: ``append=False``
    truncates any existing file at the first write, ``append=True`` continues
    it, so a resumed training keeps one contiguous log and a fresh run never
    inherits rows from a previous one)."""

    def __init__(self, filename, append=False):
        self.filename = filename
        self._initialized = append and os.path.exists(filename)
        self.fieldnames: Optional[List[str]] = None
        self._warned_extras = False
        if self._initialized:
            # Resuming: keep the existing header so appended rows stay
            # aligned with it even if this run's metric keys differ.
            with open(filename, newline="") as f:
                header = next(csv.reader(f), None)
            if header:
                self.fieldnames = header

    def on_epoch_end(self, epoch, logs, trainer):
        if trainer is not None and not trainer.is_writer:
            return  # under data parallelism, rank 0 writes the log
        # The header is fixed at the first write: a metric appearing later is
        # dropped with a one-time warning instead of misaligning the columns,
        # and a metric that disappears leaves its column empty.
        if self.fieldnames is None:
            self.fieldnames = ["epoch"] + sorted(logs)
        write_header = not self._initialized
        row = {"epoch": epoch}
        extras = []
        for k, v in logs.items():
            if k in self.fieldnames:
                row[k] = float(v)
            else:
                extras.append(k)
        if extras and not self._warned_extras:
            self._warned_extras = True
            print(
                f"CSVLogger: metrics {extras} appeared after the header was "
                f"written to {self.filename}; they will not be logged."
            )
        with open(self.filename, "a" if self._initialized else "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self.fieldnames, restval="")
            if write_header:
                writer.writeheader()
                self._initialized = True
            writer.writerow(row)


class LearningRateScheduler(Callback):
    """Set the LR scale from a ``schedule(epoch) -> lr`` function at epoch
    *begin* (Keras semantics: ``schedule(0)`` governs the first epoch)."""

    def __init__(self, schedule: Callable[[int], float], base_lr: float):
        self.schedule = schedule
        self.base_lr = base_lr

    def on_epoch_begin(self, epoch, logs, trainer):
        trainer.set_lr_scale(self.schedule(epoch) / self.base_lr)


class TerminateOnNaN(Callback):
    """Stop training on a non-finite loss, and set
    ``trainer.terminated_on_nan`` so a driver can tell a divergence from an
    EarlyStopping stop."""

    def on_epoch_end(self, epoch, logs, trainer):
        loss = logs.get("loss")
        if loss is not None and not math.isfinite(loss):
            trainer.stop_training = True
            trainer.terminated_on_nan = True


class EarlyStopping(Callback):
    def __init__(self, monitor="val_loss", min_delta=0.0, patience=10, mode="min"):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.wait = 0

    def on_epoch_end(self, epoch, logs, trainer):
        value = logs.get(self.monitor)
        if value is None:
            return
        improved = (
            value < self.best - self.min_delta
            if self.mode == "min"
            else value > self.best + self.min_delta
        )
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                trainer.stop_training = True


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor="val_loss", factor=0.2, patience=8,
                 min_lr_scale=1e-5, mode="min"):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.min_lr_scale = min_lr_scale
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.wait = 0

    def on_epoch_end(self, epoch, logs, trainer):
        value = logs.get(self.monitor)
        if value is None:
            return
        improved = value < self.best if self.mode == "min" else value > self.best
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                trainer.set_lr_scale(
                    max(self.min_lr_scale, trainer.lr_scale * self.factor)
                )
                self.wait = 0


# --------------------------------------------------------------------------- #
# Trainer
# --------------------------------------------------------------------------- #


class Trainer:
    """Drives a train step over a generator of ``(images, y_true, ...)``
    batches, with callbacks. Batches go to the module's device. ``step``
    counts the train steps taken.

    With ``mesh`` (the steps built with the same mesh), each rank runs its
    own Trainer over its rows of every global batch. The steps' metrics are
    global, so every rank logs the same losses and its callbacks decide
    the same way; rank 0 alone writes checkpoints and the CSV log
    (``is_writer``), and a restore waits for every rank first.

    Each step is a span ``train.step`` (its id the step count) over
    ``train.next_batch``, ``train.prepare`` and the step's own
    ``train.forward``, ``train.loss``, ``train.backward`` and
    ``train.optimizer``; the epoch's loss read is ``train.epoch_end``; the
    counters ``train.steps`` and ``train.images`` count the work
    (``utils.profiling``).
    """

    def __init__(self, module: nn.Module, optimizer: torch.optim.Optimizer, train_step,
                 eval_step=None, base_lr: float = 1e-3, mesh=None):
        self.module = module
        self.optimizer = optimizer
        self.train_step = train_step
        self.eval_step = eval_step
        self.base_lr = base_lr
        self.mesh = mesh
        self.is_writer = mesh is None or mesh.get_local_rank() == 0
        self.device = next(module.parameters()).device
        self.step = 0
        self.stop_training = False
        self.terminated_on_nan = False
        self.lr_scale = 1.0

    def set_lr_scale(self, scale: float):
        self.lr_scale = float(scale)
        self.set_lr(self.base_lr * self.lr_scale)

    def set_lr(self, lr: float):
        """Set every param group's learning rate; momentum and moment
        buffers are left as they are."""
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)

    def save_checkpoint(self, directory, step: int) -> str:
        """Write ``{directory}/ckpt_{step}.pt`` (model and optimizer state,
        train-step count) and return its path. Under a mesh only rank 0
        writes; the state is equal on every rank."""
        directory = os.path.abspath(directory)
        path = os.path.join(directory, f"ckpt_{step}.pt")
        if self.is_writer:
            os.makedirs(directory, exist_ok=True)
            torch.save({"model": self.module.state_dict(),
                        "optimizer": self.optimizer.state_dict(),
                        "step": self.step}, path)
        return path

    def restore_checkpoint(self, path):
        """Load a checkpoint; under a mesh every rank loads it after all
        ranks (rank 0's write among them) have reached the restore."""
        if self.mesh is not None:
            dist.barrier(group=mesh_group(self.mesh))
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.module.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.step = int(ckpt["step"])

    def _prepare(self, images, y_true):
        # Batches already on the device pass through untouched.
        def to_device(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
            return x.to(self.device, non_blocking=True)

        return to_device(images), to_device(y_true)

    def fit_generator(
        self,
        generator,
        steps_per_epoch: int,
        epochs: int,
        callbacks: Optional[List[Callback]] = None,
        val_generator=None,
        validation_steps: int = 0,
        initial_epoch: int = 0,
        lr_schedule: Optional[Callable[[int], float]] = None,
        base_lr: float = 1e-3,
        verbose: bool = True,
    ):
        """The fit loop (Keras ``fit_generator``). ``lr_schedule(epoch)`` sets
        the LR scale to ``lr_schedule(epoch) / base_lr`` at each epoch's
        begin. Returns the history ``{metric: [one value per epoch]}``."""
        callbacks = list(callbacks or [])
        history: Dict[str, List[float]] = {}

        for epoch in range(initial_epoch, epochs):
            if lr_schedule is not None:
                self.set_lr_scale(lr_schedule(epoch) / base_lr)
            for cb in callbacks:
                cb.on_epoch_begin(epoch, {}, self)
            epoch_losses = []
            t0 = time.perf_counter()
            for _ in range(steps_per_epoch):
                with span("train.step", id=self.step):
                    with span("train.next_batch"):
                        batch = next(generator)
                    with span("train.prepare"):
                        images, y_true = self._prepare(*batch[:2])
                    epoch_losses.append(self.train_step(images, y_true)["loss"])
                count("train.steps")
                count("train.images", int(images.shape[0]))
                self.step += 1
            with span("train.epoch_end"):
                logs = {"loss": float(torch.stack(epoch_losses).mean())}
            if val_generator is not None and self.eval_step is not None and validation_steps:
                val_losses = [self.eval_step(*self._prepare(*next(val_generator)[:2]))
                              for _ in range(validation_steps)]
                logs["val_loss"] = float(torch.stack(val_losses).mean())
            if verbose:
                dt = time.perf_counter() - t0
                msg = " ".join(f"{k}={v:.4f}" for k, v in logs.items())
                print(f"epoch {epoch + 1}/{epochs} [{dt:.1f}s] {msg}")
            for k, v in logs.items():
                history.setdefault(k, []).append(v)
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs, self)
            if self.stop_training:
                break
        return history


def fit_generator(*args, trainer: Trainer, **kwargs):
    """``trainer.fit_generator(*args, **kwargs)``: the functional form of the
    reference notebooks' entry point (``ssd_keras_tpu/train.py:
    fit_generator``)."""
    return trainer.fit_generator(*args, **kwargs)
