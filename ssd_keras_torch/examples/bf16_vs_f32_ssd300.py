"""bf16 against f32 at SSD300 scale: two training segments from one init.

Port of the JAX package's ``examples/bf16_vs_f32_ssd300.py``. SSD300 trains
twice on SynthVOC from the same seeded initialization on the same batch
sequence (the same rows drawn and the same on-device augmentation draws):
once with bfloat16 compute, once with float32; the parameters are float32
in both. The script writes the paired loss trajectories, the final
validation mAPs and the step rates, so a bf16 numerics regression shows as
a diverging pair instead of a lower final mAP.

Recipe (the JAX script's): SGD momentum 0.9, global-norm clip 5, L2 5e-4,
a linear warmup from 1% of the peak LR over ``--warmup`` steps and then the
peak, batch 32. On the card the f32 arm runs with TF32 off
(``torch.backends.cudnn.allow_tf32`` and ``torch.backends.cuda.matmul.
allow_tf32`` False), so it is true float32; the record says so.

Usage: python -m ssd_keras_torch.examples.bf16_vs_f32_ssd300 --steps 2000
Writes the record (markdown) to ``--out``; prints ``RESULT {json}``.
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
from ssd_keras_torch.data.synthvoc import SynthVOC
from ssd_keras_torch.encoder import pad_labels
from ssd_keras_torch.eval.evaluator import Evaluator
from ssd_keras_torch.examples.common import add_device_args, device_of
from ssd_keras_torch.models import ssd_300

DTYPES = (("bf16", torch.bfloat16), ("f32", torch.float32))


def paired_record(args, runs) -> tuple:
    """The JAX script's record and paired table from the two arms' runs:
    (record dict, [(step, loss bf16, loss f32, delta)])."""
    b, f = runs["bf16"], runs["f32"]
    paired = [
        (lb["step"], lb["loss"], lf["loss"], round(lb["loss"] - lf["loss"], 4))
        for lb, lf in zip(b["losses"], f["losses"])
    ]
    record = {
        "steps": args.steps,
        "batch": args.batch,
        "final_loss_bf16": b["final_loss"],
        "final_loss_f32": f["final_loss"],
        "final_loss_delta": round(b["final_loss"] - f["final_loss"], 4),
        "max_abs_loss_delta": max(abs(d[3]) for d in paired),
        "val_mAP_bf16": b["val_mAP_sample"],
        "val_mAP_f32": f["val_mAP_sample"],
        "val_mAP_delta": round(b["val_mAP_sample"] - f["val_mAP_sample"], 4),
        "img_per_s_bf16": b["img_per_s"],
        "img_per_s_f32": f["img_per_s"],
    }
    return record, paired


def write_record(path, record, paired, device) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("# bf16 vs f32 at SSD300 scale (SynthVOC segment)\n\n")
        fh.write(
            "Two training segments from the same init on the same batch "
            "sequence; only the compute dtype differs (params stay float32 "
            "in both). Bounds the bf16 numerics the committed SynthVOC "
            "curves rely on.\n\n")
        fh.write(f"Device: {device_name(device)}. The f32 arm runs with TF32 off "
                 "(cudnn.allow_tf32 and cuda.matmul.allow_tf32 False).\n\n")
        fh.write("```json\n" + json.dumps(record, indent=2) + "\n```\n\n")
        fh.write("| step | loss bf16 | loss f32 | delta |\n|---|---|---|---|\n")
        for s, lb, lf, d in paired:
            fh.write(f"| {s} | {lb} | {lf} | {d} |\n")
        fh.write("\n")


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="bf16 vs f32 SSD300 training segments")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--train-images", type=int, default=2000)
    p.add_argument("--val-images", type=int, default=320)
    p.add_argument("--peak-lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "bf16_vs_f32_ssd300.md"))
    add_device_args(p, compute_dtype=None)
    args = p.parse_args(argv)

    device = device_of(args)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    n_classes = 20
    cfg = SSDConfig.ssd300(n_classes=n_classes)

    print(f"Rendering SynthVOC: {args.train_images} train / "
          f"{args.val_images} val ...", flush=True)
    train_ds = SynthVOC(args.train_images, 300, split="train", seed=args.seed)
    val_ds = SynthVOC(args.val_images, 300, split="val", seed=args.seed)
    train_images, train_labels = train_ds.materialize()
    val_images, val_labels = val_ds.materialize()

    aug = DeviceSSDAugmentation(300, 300)
    images_d = torch.from_numpy(train_images).to(device)
    encoder = padded = counts = None

    runs = {}
    for dtype_name, dtype in DTYPES:
        # The same f32 init in both arms: one seeded generator each.
        model, sizes = ssd_300(cfg, compute_dtype=dtype, device=device,
                               generator=torch.Generator().manual_seed(args.seed))
        if encoder is None:
            encoder = SSDInputEncoder(cfg, sizes, max_gt_boxes=16, device=device)
            padded_np, counts_np = pad_labels(train_labels, encoder.max_gt_boxes, truncate=True)
            padded = torch.from_numpy(padded_np).to(device)
            counts = torch.from_numpy(counts_np).to(device)
        optimizer = T.sgd_with_momentum(model.parameters(),
                                        T.linear_warmup_lr(args.peak_lr, args.warmup),
                                        momentum=0.9, clipnorm=5.0)
        train_step = T.make_train_step(model, optimizer, SSDLoss(), l2_reg=5e-4)

        # The same batch and augmentation sequence in both arms.
        picker = torch.Generator(device=device).manual_seed(args.seed + 1)
        losses = []
        t0 = time.time()
        timed_from = min(50, args.steps - 1)  # the first steps pay the set-up
        for step in range(args.steps):
            if step == timed_from:
                t0 = time.time()
            idx = torch.randint(args.train_images, (args.batch,), generator=picker,
                                device=device)
            imgs, lbls, nn = aug(batch_seed(args.seed + 1, step), images_d[idx],
                                 padded[idx], counts[idx])
            metrics = train_step(imgs, encoder.encode_padded(lbls, nn))
            if step % 100 == 0 or step + 1 == args.steps:
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    print(f"[{dtype_name}] step {step}: non-finite loss", flush=True)
                    sys.exit(2)
                losses.append({"step": step, "loss": round(loss, 4)})
                print(f"[{dtype_name}] step {step:5d} loss {loss:8.3f}", flush=True)
        seconds = time.time() - t0

        model.eval()
        val_gen = val_ds.as_data_generator(val_images, val_labels)
        ev = Evaluator(model, n_classes, val_gen, model_mode="training", device=device)
        with torch.no_grad():
            mean_ap = float(ev(img_height=300, img_width=300, batch_size=args.batch,
                               verbose=False))
        timed_steps = args.steps - timed_from
        runs[dtype_name] = {
            "losses": losses,
            "final_loss": losses[-1]["loss"],
            "val_mAP_sample": round(mean_ap, 4),
            "train_seconds": round(seconds, 1),
            "img_per_s": round(timed_steps * args.batch / seconds, 1),
        }
        print(f"[{dtype_name}] mAP {mean_ap:.4f}  "
              f"{runs[dtype_name]['img_per_s']} img/s", flush=True)
        del model, optimizer, train_step

    record, paired = paired_record(args, runs)
    write_record(args.out, record, paired, device)
    print("RESULT " + json.dumps(record))
    return dict(record=record, paired=paired, runs=runs, out=args.out,
                device=device_name(device))


if __name__ == "__main__":
    main()
