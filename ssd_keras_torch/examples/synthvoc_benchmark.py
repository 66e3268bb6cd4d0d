"""SynthVOC benchmark: train SSD on the synthetic 20-class VOC proxy to a
validation-mAP curve.

Port of the JAX package's ``examples/synthvoc_benchmark.py``, with its
recipes (``build_optimizer``):

* **ssd300** / **ssd512**: SGD momentum 0.9, global-norm clip 5, L2 5e-4,
  batch 32, bf16 compute over f32 weights, a linear warmup from 1% of the
  peak LR (the stand-in for the reference's pretrained VGG), then x0.1 drops
  at 2/3 and 5/6 of the run;
* **ssd7**: Adam 1e-3 (clip 5), batch <= 16.

The train split is uploaded to the card once as uint8; each step draws its
rows there, augments them (``DeviceSSDAugmentation``) and encodes them
(``encode_padded``). Every ``--eval-every`` steps the validation mAP
('sample', 11-point) goes to ``synthvoc_<model>_curve.jsonl`` as one JSON
line (also printed after ``EVAL``), with a checkpoint; the end writes both
AP modes and the per-class table to ``synthvoc_<model>_summary.md`` and
prints ``FINAL val mAP sample=... integrate=...``. ``--resume`` continues
from the newest checkpoint.

Usage:
  python -m ssd_keras_torch.examples.synthvoc_benchmark --model ssd300 --steps 24000
  python -m ssd_keras_torch.examples.synthvoc_benchmark --model ssd7 --steps 12000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ssd_keras_torch import SSDConfig, SSDInputEncoder, SSDLoss
from ssd_keras_torch import train as T
from ssd_keras_torch.data.device_aug import DeviceSSDAugmentation, batch_seed
from ssd_keras_torch.data.synthvoc import SYNTHVOC_CLASS_NAMES, SynthVOC
from ssd_keras_torch.encoder import pad_labels
from ssd_keras_torch.eval.evaluator import Evaluator
from ssd_keras_torch.examples.common import checkpoint_step, device_of
from ssd_keras_torch.models import ssd_7, ssd_300, ssd_512


def build_model(name: str, n_classes: int, device):
    if name == "ssd300":
        cfg = SSDConfig.ssd300(n_classes=n_classes)
        model, sizes = ssd_300(cfg, compute_dtype=torch.bfloat16, device=device)
    elif name == "ssd512":
        cfg = SSDConfig.ssd512(n_classes=n_classes)
        model, sizes = ssd_512(cfg, compute_dtype=torch.bfloat16, device=device)
    elif name == "ssd7":
        cfg = SSDConfig.ssd7(n_classes=n_classes, img_height=300, img_width=300)
        model, sizes = ssd_7(cfg, compute_dtype=torch.bfloat16, device=device)
    else:
        raise ValueError(name)
    return cfg, model, sizes


def lr_schedule(name: str, steps: int, peak_lr: float, warmup: int):
    """The learning rate before update ``step``, as the JAX recipe's optax
    schedule gives it. SSD7: constant. SSD300/512: ``join_schedules`` of a
    linear warmup from 1% of the peak and a piecewise-constant schedule with
    x0.1 drops at 2/3 and 5/6 of the run; ``join_schedules`` passes
    ``step - warmup`` to the second, so the drop keys are shifted to land
    at the intended global steps."""
    if name == "ssd7":
        return lambda step: peak_lr
    warm = T.linear_warmup_lr(peak_lr, warmup)
    drops = T.piecewise_lr(peak_lr, {
        max(1, int(steps * 2 / 3) - warmup): 0.1,
        max(2, int(steps * 5 / 6) - warmup): 0.1,
    })
    return lambda step: warm(step) if step < warmup else drops(step - warmup)


def build_optimizer(name: str, params, steps: int, peak_lr: float, warmup: int,
                    clipnorm: float):
    """Returns (optimizer, schedule): Adam for SSD7, SGD momentum 0.9 for
    SSD300/512, both clipped to a global norm of ``clipnorm``."""
    sched = lr_schedule(name, steps, peak_lr, warmup)
    if name == "ssd7":
        # The canonical SSD7 recipe: Adam 1e-3 (ssd7_training.ipynb cell 7).
        return T.adam(params, peak_lr, clipnorm=clipnorm), sched
    return T.sgd_with_momentum(params, sched, momentum=0.9, clipnorm=clipnorm), sched


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="train SSD on SynthVOC to a val-mAP curve")
    p.add_argument("--model", choices=["ssd300", "ssd512", "ssd7"], default="ssd300")
    p.add_argument("--steps", type=int, default=24000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--train-images", type=int, default=4000)
    p.add_argument("--val-images", type=int, default=800)
    p.add_argument("--eval-every", type=int, default=2000)
    p.add_argument("--peak-lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--clipnorm", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "synthvoc_benchmark"),
                   help="directory of the curve and the summary")
    p.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "synthvoc_ckpt"))
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.model == "ssd7":
        args.batch = min(args.batch, 16)

    device = device_of(args)
    os.makedirs(args.out, exist_ok=True)
    curve_path = os.path.join(args.out, f"synthvoc_{args.model}_curve.jsonl")
    summary_path = os.path.join(args.out, f"synthvoc_{args.model}_summary.md")

    n_classes = 20
    torch.manual_seed(args.seed)
    cfg, model, sizes = build_model(args.model, n_classes, device)
    encoder = SSDInputEncoder(cfg, sizes, max_gt_boxes=16, device=device)
    aug = DeviceSSDAugmentation(cfg.img_height, cfg.img_width)

    print(f"Rendering SynthVOC: {args.train_images} train / {args.val_images} val ...",
          flush=True)
    t0 = time.time()
    train_ds = SynthVOC(args.train_images, cfg.img_height, split="train", seed=args.seed)
    val_ds = SynthVOC(args.val_images, cfg.img_height, split="val", seed=args.seed)
    train_images, train_labels = train_ds.materialize()
    val_images, val_labels = val_ds.materialize()
    render_s = time.time() - t0
    print(f"  rendered in {render_s:.0f}s", flush=True)

    padded, counts = pad_labels(train_labels, encoder.max_gt_boxes, truncate=True)
    t0 = time.time()
    images_d = torch.from_numpy(train_images).to(device)
    padded_d = torch.from_numpy(padded).to(device)
    counts_d = torch.from_numpy(counts).to(device)
    float(counts_d.sum())  # wait for the uploads
    print(f"  train set resident on device in {time.time() - t0:.0f}s "
          f"({train_images.nbytes / 1e6:.0f} MB)", flush=True)

    optimizer, sched = build_optimizer(args.model, model.parameters(), args.steps,
                                       args.peak_lr, args.warmup, args.clipnorm)
    train_step = T.make_train_step(model, optimizer, SSDLoss(), l2_reg=5e-4)
    trainer = T.Trainer(model, optimizer, train_step)  # the checkpoint helper

    start_step = 0
    if args.resume and os.path.isdir(args.ckpt):
        ckpts = [d for d in os.listdir(args.ckpt) if checkpoint_step(d) >= 0]
        if ckpts:
            latest = max(ckpts, key=checkpoint_step)
            trainer.restore_checkpoint(os.path.join(args.ckpt, latest))
            start_step = checkpoint_step(latest)
            print(f"Resumed from step {start_step}", flush=True)

    if start_step == 0 and os.path.exists(curve_path):
        os.remove(curve_path)  # a fresh run: do not append to a previous curve

    val_gen = val_ds.as_data_generator(val_images, val_labels)

    def evaluate(mode="sample"):
        model.eval()  # BatchNorm (SSD7) on its running statistics
        ev = Evaluator(model, n_classes, val_gen, model_mode="training", device=device)
        with torch.no_grad():
            mean_ap, aps = ev(img_height=cfg.img_height, img_width=cfg.img_width,
                              batch_size=args.batch, average_precision_mode=mode,
                              return_average_precisions=True, verbose=False)
        return float(mean_ap), [float(a) for a in aps]

    picker = torch.Generator(device=device).manual_seed(args.seed + 1)
    train_s, steps_done = 0.0, 0
    t_train = t_run = time.time()
    for step in range(start_step, args.steps):
        idx = torch.randint(args.train_images, (args.batch,), generator=picker, device=device)
        imgs, lbls, nn = aug(batch_seed(args.seed + 1, step), images_d[idx], padded_d[idx],
                             counts_d[idx])
        metrics = train_step(imgs, encoder.encode_padded(lbls, nn))
        steps_done += 1
        if step % 200 == 0:
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                print(f"step {step}: NaN loss -- aborting", flush=True)
                sys.exit(2)
            rate = 200 * args.batch / max(1e-9, time.time() - t_train)
            t_train = time.time()
            print(f"step {step:6d}  loss {loss:8.3f}  lr {sched(step):.2e}  "
                  f"{rate:.0f} img/s", flush=True)
        if (step + 1) % args.eval_every == 0 or step + 1 == args.steps:
            train_s += time.time() - t_run
            t_eval = time.time()
            mean_ap, _ = evaluate()
            record = {
                "model": args.model, "step": step + 1,
                "val_mAP_sample": round(mean_ap, 4),
                "loss": round(float(metrics["loss"]), 3),
                "lr": float(sched(step)),
                "eval_seconds": round(time.time() - t_eval, 1),
            }
            with open(curve_path, "a") as f:
                f.write(json.dumps(record) + "\n")
            print("EVAL " + json.dumps(record), flush=True)
            trainer.step = step + 1
            trainer.save_checkpoint(args.ckpt, step=step + 1)
            t_train = t_run = time.time()

    # Final: both AP modes and the per-class table.
    map_sample, aps_sample = evaluate("sample")
    map_integrate, aps_integrate = evaluate("integrate")
    with open(summary_path, "w") as f:
        f.write(f"# SynthVOC {args.model} benchmark (ssd_keras_torch)\n\n")
        f.write(f"- steps: {args.steps}, batch {args.batch}, "
                f"peak lr {args.peak_lr} (warmup {args.warmup}), "
                f"L2 5e-4, bf16 compute, device augmentation chain\n")
        f.write(f"- train/val: {args.train_images}/{args.val_images} images, "
                f"seed {args.seed} (deterministic, see data/synthvoc.py)\n")
        f.write(f"- device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                + "\n\n")
        f.write("## Results\n\n")
        f.write(f"- **val mAP (sample, 11-point): {map_sample:.4f}**\n")
        f.write(f"- val mAP (integrate): {map_integrate:.4f}\n\n")
        f.write("| class | AP (sample) | AP (integrate) |\n|---|---|---|\n")
        for i in range(1, n_classes + 1):
            f.write(f"| {SYNTHVOC_CLASS_NAMES[i]} | {aps_sample[i]:.4f} | "
                    f"{aps_integrate[i]:.4f} |\n")
    print(f"FINAL val mAP sample={map_sample:.4f} integrate={map_integrate:.4f}")
    print(f"Curve: {curve_path}\nSummary: {summary_path}")
    return dict(model=args.model, steps=args.steps, batch=args.batch,
                train_images=args.train_images, val_images=args.val_images,
                map_sample=map_sample, map_integrate=map_integrate,
                train_seconds=train_s, render_seconds=render_s,
                img_per_s=steps_done * args.batch / train_s if train_s else None,
                curve=curve_path, summary=summary_path)


if __name__ == "__main__":
    main()
