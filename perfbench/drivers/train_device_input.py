"""Training through ``Trainer.fit_generator`` fed by the device input
pipeline.

Set-up: the seeded weights and the port's 'training' model, SGD with
momentum and the L2 term as the cell states, ``make_train_step`` and a
``Trainer``; a resident split of seeded uint8 images and padded labels on
the card (``traffic.training_split``); a generator that takes each batch's
rows (a seeded order, every row once an epoch), runs
``DeviceSSDAugmentation`` and ``SSDInputEncoder.encode_padded`` on the
card and yields the batch. The first three steps go through
``fit_generator`` with that generator, one step an epoch, and are what the
check compares. Window: ``fit_generator`` epochs of ``steps_per_epoch``
steps back to back, until one ends after ``--seconds``;
``train_img_per_s`` is the images trained over the window's time.

Check: the plain reference re-derives the first three batches from the
same split (its own copy of the augmentation, its own encoder) and takes
the same three steps in float32; compared are the first step's loss
(relative), the first gradient's norm (the program's from its momentum
buffer after one step) and the parameters' change after three steps, the
last two by the median leaf. The later steps' losses and the worst leaves
swing with the seed, and bf16's rounding alone swings them: the plain
reference rounded to bf16 reads worst leaves of 0.40-0.51 against itself
in float32 on the seeds where the program reads 0.41-0.66, while the
program in float32 agrees with the reference to 5e-5 on every leaf
(``PERF.md``). They are printed beside, not compared.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from perfbench import harness, port, traffic, weights
from perfbench.reference import augment, ssd
from perfbench.reference import train as ref_train


def batches(run, split, aug, enc, rows_of):
    """The program's feed: batch i's rows, augmented and encoded on the card."""
    images, padded, counts = split
    events = run.trace and run.device.type == "cuda"
    i = 0
    while True:
        rows = rows_of(i)
        if events:
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            begin.record()
        with run.span("input"):
            x, p, c = aug(augment.batch_seed(run.seed, i), images[rows], padded[rows],
                          counts[rows])
            y = enc.encode_padded(p, c)
        if events:
            end.record()
            run.values.setdefault("input_events", []).append((begin, end))
        yield x, y
        i += 1


def rows_by_batch(seed: int, n: int, batch: int):
    per_epoch = n // batch
    orders = {}

    def rows_of(i):
        epoch, j = divmod(i, per_epoch)
        if epoch not in orders:
            orders[epoch] = torch.from_numpy(traffic.rng(seed, 100 + epoch).permutation(n))
        return orders[epoch][j * batch:(j + 1) * batch]
    return rows_of


def run(run: harness.Run) -> None:
    from ssd_keras_torch import train
    from ssd_keras_torch.data.device_aug import DeviceSSDAugmentation
    from ssd_keras_torch.encoder import SSDInputEncoder
    from ssd_keras_torch.loss import SSDLoss

    cell, config, p, opt = run.cell, run.config, run.cell["traffic"], run.cell["optimizer"]
    device = run.device
    params = weights.seeded(config, run.seed, device)
    model = port.model(config, "training", params, device)
    optimizer = train.sgd_with_momentum(
        model.parameters(), train.linear_warmup_lr(opt["lr"], opt["warmup_steps"],
                                                   opt["warmup_from"]),
        opt["momentum"], clipnorm=opt["clipnorm"])
    step = train.make_train_step(model, optimizer, SSDLoss(neg_pos_ratio=opt["neg_pos_ratio"]),
                                 l2_reg=opt["l2_reg"])
    trainer = train.Trainer(model, optimizer, timed_step(run, step), base_lr=opt["lr"])
    split = traffic.training_split(p, run.seed, device)
    b = cell["batch_size"]
    rows_of = rows_by_batch(run.seed, p["images"], b)
    enc = SSDInputEncoder(port.ssd_config(config), ssd.predictor_sizes(config),
                          max_gt_boxes=p["max_gt"], device=device)
    feed = batches(run, split, DeviceSSDAugmentation(config["img_height"], config["img_width"]),
                   enc, rows_of)

    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    losses = []
    for k in range(3):  # the steps the check compares, through the window's call and feed
        losses.append(trainer.fit_generator(feed, 1, 1, verbose=False)["loss"][0])
        if k == 0:
            first = {name: optimizer.state[param].get("momentum_buffer", torch.zeros_like(param))
                     .clone() for name, param in model.named_parameters()}
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    run.warm_profiler()
    harness.synchronize(device)
    run.spans.clear()
    run.values.clear()
    run.setup_done()

    epochs, steps, traced, t0 = 0, 0, 0.0, time.perf_counter()
    while True:
        prof = run.profiler() if epochs == p["trace_epoch"] else None
        t1 = time.perf_counter()
        trainer.fit_generator(feed, p["steps_per_epoch"], 1, verbose=False)
        if prof is not None:
            run.stop_profiler(prof)
            traced = time.perf_counter() - t1
        epochs += 1
        steps += p["steps_per_epoch"]
        if time.perf_counter() - t0 >= run.seconds and (not run.trace or run.traced):
            break
    window = time.perf_counter() - t0
    run.attempted = steps
    run.e2e[cell["metric"]] = steps * b / window
    # The rate of the epochs the profiler did not slow, for the readers.
    run.values.update(window_s=window - traced,
                      images=(steps - (p["steps_per_epoch"] if traced else 0)) * b)
    if run.trace:
        run.values.update(input_ms=events_ms(run, "input_events"),
                          step_ms=events_ms(run, "step_events"))

    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    del trainer, step, optimizer, model, feed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge(run, params, split, rows_of, losses, first, start, after)
    for name, limit in cell["check"]["limits"].items():
        run.check(name, numbers[name], limit)


def timed_step(run, step):
    """The train step, with CUDA events and a span around it in a traced
    run."""
    if not run.trace or run.device.type != "cuda":
        return step

    def call(images, y_true):
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        with run.span("step"):
            out = step(images, y_true)
        end.record()
        run.values.setdefault("step_events", []).append((begin, end))
        return out
    return call


def events_ms(run, key: str):
    pairs = run.values.pop(key, [])
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs])) if pairs else None


def reference_batches(run, split, rows_of, n: int = 3):
    """The first ``n`` batches as the reference derives them: its copy of
    the augmentation and its own encoder, from the same split and seeds."""
    images, padded, counts = split
    anchor8 = torch.from_numpy(ssd.anchors(run.config)).float().to(run.device)
    out = []
    for i in range(n):
        rows = rows_of(i)
        x, labels, c = augment.augment(augment.batch_seed(run.seed, i), images[rows],
                                       padded[rows], counts[rows], run.config["img_height"],
                                       run.config["img_width"])
        out.append((x, ref_train.encode(run.config, labels, c, anchor8)))
    return out


def judge(run, params, split, rows_of, losses, first, start, after) -> dict:
    """The check's numbers for the program's three steps (``losses``, its
    momentum buffers after the first, ``first``, its parameters before and
    after, ``start`` and ``after``) against the reference's."""
    ssd.exact_float32()
    ref_losses, ref_grad, ref_after = ref_train.sgd_steps(
        run.config, params, reference_batches(run, split, rows_of), run.cell["optimizer"])
    change = {k: after[k] - start[k] for k in ref_after}
    ref_change = {k: ref_after[k] - params[k] for k in ref_after}
    gaps = dict(grad_gap=ref_train.leaf_gaps(first, ref_grad, ref_grad),
                update_gap=ref_train.leaf_gaps(change, ref_change, ref_grad))
    for name, leaves in gaps.items():
        worst = max(leaves, key=leaves.get)
        print(f"{name} by the worst leaf (not compared): {leaves[worst]!r} ({worst})",
              file=sys.stderr)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(f"loss gaps of the three steps (the first compared): {rel!r}", file=sys.stderr)
    return dict(loss_gap=rel[0],
                **{name: float(np.median(list(v.values()))) for name, v in gaps.items()})


def control(run: harness.Run, quantize) -> dict:
    """The check's numbers with the reference computed in ``quantize`` in
    the program's place."""
    params = weights.seeded(run.config, run.seed, run.device)
    split = traffic.training_split(run.cell["traffic"], run.seed, run.device)
    rows_of = rows_by_batch(run.seed, run.cell["traffic"]["images"], run.cell["batch_size"])
    ssd.exact_float32()
    losses, grad, after = ref_train.sgd_steps(
        run.config, params, reference_batches(run, split, rows_of), run.cell["optimizer"],
        quantize=quantize)
    return judge(run, params, split, rows_of, losses, grad, params, after)


# Faults the training cell can have, planted in the reference put in the
# program's place: each changes the batches the three steps take.
FAULTS = {
    "half_the_batch": lambda x, y: (x[: len(x) // 2], y[: len(y) // 2]),
    "targets_altered": lambda x, y: (x, torch.roll(y, 1, dims=1)),
}


def fault(run: harness.Run, name: str) -> dict:
    """The check's numbers with the fault ``name`` planted in the reference
    put in the program's place."""
    params = weights.seeded(run.config, run.seed, run.device)
    split = traffic.training_split(run.cell["traffic"], run.seed, run.device)
    rows_of = rows_by_batch(run.seed, run.cell["traffic"]["images"], run.cell["batch_size"])
    ssd.exact_float32()
    batches = [FAULTS[name](x, y) for x, y in reference_batches(run, split, rows_of)]
    losses, grad, after = ref_train.sgd_steps(run.config, params, batches, run.cell["optimizer"])
    return judge(run, params, split, rows_of, losses, grad, params, after)
