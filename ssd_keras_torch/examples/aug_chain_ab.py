"""A/B: the host SSDDataAugmentation chain against DeviceSSDAugmentation, at
the mAP level.

Port of the JAX package's ``examples/aug_chain_ab.py``. SSD300 (or SSD512)
trains on SynthVOC twice from the same seeded initialization, optimizer,
LR schedule and step budget; the only difference between the arms is the
augmentation chain that makes the training batches:

* arm ``host``: the reference's chain (``data/chains.py``
  ``SSDDataAugmentation``: photometric sequence, expand, the patch-sampling
  crop trials, flip), on the host (NumPy, its resize and colour
  conversions in the host C++ of ``native.image_ops``) through
  ``DataGenerator.generate``
  and ``data/prefetch.prefetch``, or with ``--host-workers N`` in N
  processes, each over its own rows;
* arm ``device``: ``DeviceSSDAugmentation`` on the model's device, over the
  train split resident there.

Both arms encode their targets on the device (``encode_padded``), so the
chain is the one variable. Recipe (``synthvoc_benchmark.build_optimizer``):
SGD momentum 0.9, clip 5, L2 5e-4, a warmup to the peak LR, x0.1 drops at
2/3 and 5/6 of the steps, batch 32. Writes each arm's val mAP curve
(``aug_chain_ab_{arm}_curve.jsonl``) and, with both arms,
``aug_chain_ab.md`` with the final delta (acceptance: |delta| <= 0.02).

Usage: python -m ssd_keras_torch.examples.aug_chain_ab --steps 8000 [--arms device]
       [--host-workers N]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
import time

import numpy as np
import torch

from ssd_keras_torch import SSDConfig, SSDInputEncoder, SSDLoss
from ssd_keras_torch import train as T
from ssd_keras_torch.data.chains import SSDDataAugmentation
from ssd_keras_torch.data.device_aug import DeviceSSDAugmentation, batch_seed
from ssd_keras_torch.data.prefetch import prefetch
from ssd_keras_torch.data.synthvoc import SynthVOC
from ssd_keras_torch.encoder import pad_labels
from ssd_keras_torch.eval.evaluator import Evaluator
from ssd_keras_torch.examples.common import add_device_args, device_of, dtype_of
from ssd_keras_torch.examples.synthvoc_benchmark import build_optimizer
from ssd_keras_torch.models import ssd_300, ssd_512

BUILDERS = {"ssd300": (ssd_300, SSDConfig.ssd300), "ssd512": (ssd_512, SSDConfig.ssd512)}


def build(args, device):
    """A fresh model from the seed (the same init in every arm) and its
    config and predictor sizes."""
    builder, config = BUILDERS[args.model]
    cfg = config(n_classes=20)
    model, sizes = builder(cfg, compute_dtype=dtype_of(args), device=device,
                           generator=torch.Generator().manual_seed(args.seed))
    return cfg, model, sizes


def device_batches(args, encoder, data, device):
    """The device arm: rows drawn and augmented on the device."""
    train_images, train_labels = data[:2]
    aug = DeviceSSDAugmentation(args.size, args.size)
    images_d = torch.from_numpy(train_images).to(device)
    padded, counts = pad_labels(train_labels, encoder.max_gt_boxes, truncate=True)
    padded_d, counts_d = torch.from_numpy(padded).to(device), torch.from_numpy(counts).to(device)
    picker = torch.Generator(device=device).manual_seed(args.seed + 1)
    step = 0
    while True:
        idx = torch.randint(len(train_images), (args.batch,), generator=picker, device=device)
        imgs, lbls, nn = aug(batch_seed(args.seed + 1, step), images_d[idx], padded_d[idx],
                             counts_d[idx])
        step += 1
        yield imgs, encoder.encode_padded(lbls, nn)


def chain_batches(args, max_gt_boxes, images, labels, seed):
    """The reference chain over ``images``, seeded: uint8 batches with their
    padded labels and counts."""
    # The chain draws from the global generators: seeded, the arm repeats.
    np.random.seed(seed)
    random.seed(seed)
    train_ds = SynthVOC(len(images), args.size, split="train", seed=args.seed)
    gen = train_ds.as_data_generator(images, labels).generate(
        batch_size=args.batch,
        shuffle=True,
        transformations=[SSDDataAugmentation(args.size, args.size)],
        label_encoder=None,
        returns=["processed_images", "processed_labels"],
        keep_images_without_gt=True,
    )
    for imgs, lbls in gen:
        # uint8 upload (the augmented image is float32 in [0, 255];
        # rounding is the quantization every decoded JPEG has)
        u8 = np.clip(np.rint(np.asarray(imgs)), 0, 255).astype(np.uint8)
        padded, counts = pad_labels(list(lbls), max_gt_boxes, truncate=True)
        yield u8, padded, counts


class ChainShards(torch.utils.data.IterableDataset):
    """``--host-workers N``: DataLoader worker ``w`` renders the train rows
    ``w::N`` itself (a SynthVOC image is a function of its seed, split and
    index, so they equal the parent's) and runs the chain over them, seeded
    ``seed * 1000 + w``. The loader takes the workers' batches in turn, so
    the arm repeats for a given N."""

    def __init__(self, args, max_gt_boxes):
        self.args, self.max_gt_boxes = args, max_gt_boxes

    def rows(self, worker, n_workers):
        ds = SynthVOC(self.args.train_images, self.args.size, split="train", seed=self.args.seed)
        rendered = [ds.render(i) for i in range(worker, self.args.train_images, n_workers)]
        return np.stack([r[0] for r in rendered]), [r[1] for r in rendered]

    def __iter__(self):
        w = torch.utils.data.get_worker_info()
        images, labels = self.rows(w.id, w.num_workers)
        return chain_batches(self.args, self.max_gt_boxes, images, labels,
                             self.args.seed * 1000 + w.id)


def host_batches(args, encoder, data, device):
    """The host arm: the reference chain on the host, a prefetch thread ahead
    (or ``--host-workers`` processes), then the upload and the encode on the
    device."""
    train_images, train_labels = data[:2]
    if args.host_workers > 1:
        batches = iter(torch.utils.data.DataLoader(
            ChainShards(args, encoder.max_gt_boxes), batch_size=None,
            num_workers=args.host_workers, prefetch_factor=2, multiprocessing_context="spawn"))
        for u8, padded, counts in batches:
            y = encoder.encode_padded(padded.to(device), counts.to(device))
            yield u8.to(device).float(), y
        return
    batches = prefetch(chain_batches(args, encoder.max_gt_boxes, train_images, train_labels,
                                     args.seed), buffer_size=4)
    try:
        for u8, padded, counts in batches:
            y = encoder.encode_padded(torch.from_numpy(padded).to(device),
                                      torch.from_numpy(counts).to(device))
            yield torch.from_numpy(u8).to(device).float(), y
    finally:  # the arm's end closes this generator: stop the thread too
        batches.stop()


def train_arm(arm, args, encoder, data, curve_path, device):
    """Train one arm from the seeded init; returns its final mAPs."""
    _, model, _ = build(args, device)
    init_checksum = float(sum(p.detach().double().abs().sum() for p in model.parameters()))
    optimizer, sched = build_optimizer(args.model, model.parameters(), args.steps,
                                       args.peak_lr, args.warmup, args.clipnorm)
    train_step = T.make_train_step(model, optimizer, SSDLoss(), l2_reg=5e-4)

    if os.path.exists(curve_path):
        os.remove(curve_path)

    size = args.size
    val_images, val_labels = data[2:]
    val_ds = SynthVOC(args.val_images, size, split="val", seed=args.seed)

    def evaluate(mode="sample"):
        model.eval()
        ev = Evaluator(model, 20, val_ds.as_data_generator(val_images, val_labels),
                       model_mode="training", device=device)
        with torch.no_grad():
            mean_ap, aps = ev(img_height=size, img_width=size, batch_size=args.batch,
                              average_precision_mode=mode, return_average_precisions=True,
                              verbose=False)
        return float(mean_ap), [float(a) for a in aps]

    batches = device_batches if arm == "device" else host_batches
    batch_iter = batches(args, encoder, data, device)

    t_train = time.time()
    metrics = {}
    for step in range(args.steps):
        imgs, y_true = next(batch_iter)
        metrics = train_step(imgs, y_true)
        if step % 200 == 0:
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                print(f"[{arm}] step {step}: non-finite loss, aborting", flush=True)
                sys.exit(2)
            rate = 200 * args.batch / max(1e-9, time.time() - t_train)
            t_train = time.time()
            print(f"[{arm}] step {step:6d}  loss {loss:8.3f}  "
                  f"lr {sched(step):.2e}  {rate:.0f} img/s", flush=True)
        if (step + 1) % args.eval_every == 0 or step + 1 == args.steps:
            mean_ap, _ = evaluate()
            rec = {"arm": arm, "step": step + 1,
                   "val_mAP_sample": round(mean_ap, 4),
                   "loss": round(float(metrics["loss"]), 3)}
            with open(curve_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print("[EVAL] " + json.dumps(rec), flush=True)
    batch_iter.close()

    map_s, aps_s = evaluate("sample")
    map_i, _ = evaluate("integrate")

    if args.save_ckpt:
        # The trained weights, for evaluator_decode_agreement re-runs.
        trainer = T.Trainer(model, optimizer, train_step)
        path = trainer.save_checkpoint(
            os.path.join(os.path.abspath(args.save_ckpt), f"{arm}_seed{args.seed}"), step=1)
        print(f"[{arm}] checkpoint saved to {path}", flush=True)

    return {"arm": arm, "final_mAP_sample": map_s, "final_mAP_integrate": map_i,
            "aps_sample": aps_s, "init_checksum": init_checksum}


def write_record(path, args, results) -> float:
    """``aug_chain_ab.md`` (the JAX script's layout); returns the delta."""
    by = {r["arm"]: r for r in results}
    delta = by["device"]["final_mAP_sample"] - by["host"]["final_mAP_sample"]
    with open(path, "w") as f:
        f.write("# Augmentation chain A/B: host (reference-parity) vs "
                f"on-device ({args.model.upper()}, SynthVOC)\n\n")
        f.write(
            "Same init (seed {}), optimizer (SGD m=0.9, L2 5e-4, peak lr "
            "{} with {}-step warmup, x0.1 drops at 2/3 and 5/6), batch "
            "{}, {} steps, bf16; target encoding on-device in both arms. "
            "The only variable is the augmentation chain.\n\n".format(
                args.seed, args.peak_lr, args.warmup, args.batch, args.steps))
        f.write("| arm | final val mAP (sample) | final val mAP "
                "(integrate) | train s |\n|---|---|---|---|\n")
        for r in results:
            f.write(f"| {r['arm']} | {r['final_mAP_sample']:.4f} | "
                    f"{r['final_mAP_integrate']:.4f} | "
                    f"{r['train_seconds']} |\n")
        f.write(f"\n**delta mAP (device - host): {delta:+.4f}** "
                f"(acceptance: |delta| <= 0.02)\n\n")
        f.write("Curves: aug_chain_ab_device_curve.jsonl / "
                "aug_chain_ab_host_curve.jsonl\n")
    return delta


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="host vs device augmentation chain, by mAP")
    p.add_argument("--steps", type=int, default=8000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--train-images", type=int, default=4000)
    p.add_argument("--val-images", type=int, default=800)
    p.add_argument("--eval-every", type=int, default=2000)
    p.add_argument("--peak-lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--clipnorm", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model", default="ssd300", choices=("ssd300", "ssd512"))
    p.add_argument("--arms", default="device,host")
    p.add_argument("--host-workers", type=int, default=1,
                   help="processes running the host arm's chain, each over its own rows "
                        "(1: one prefetch thread over all rows, as the JAX script)")
    p.add_argument("--save-ckpt", default="",
                   help="directory to save each arm's trained weights into "
                        "({arm}_seed{seed}/ckpt_1.pt); empty = don't save")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "aug_chain_ab"))
    add_device_args(p)
    args = p.parse_args(argv)

    device = device_of(args)
    os.makedirs(args.out, exist_ok=True)
    cfg, _, sizes = build(args, device)
    args.size = cfg.img_height
    encoder = SSDInputEncoder(cfg, sizes, max_gt_boxes=16, device=device)

    print(f"Rendering SynthVOC {args.train_images}/{args.val_images} ...", flush=True)
    t0 = time.time()
    train_ds = SynthVOC(args.train_images, args.size, split="train", seed=args.seed)
    val_ds = SynthVOC(args.val_images, args.size, split="val", seed=args.seed)
    train_images, train_labels = train_ds.materialize()
    val_images, val_labels = val_ds.materialize()
    print(f"  rendered in {time.time() - t0:.0f}s", flush=True)
    data = (train_images, train_labels, val_images, val_labels)

    results = []
    for arm in args.arms.split(","):
        curve = os.path.join(args.out, f"aug_chain_ab_{arm}_curve.jsonl")
        t0 = time.time()
        res = train_arm(arm, args, encoder, data, curve, device)
        res["train_seconds"] = round(time.time() - t0, 1)
        results.append(res)
        print(f"[{arm}] FINAL mAP sample={res['final_mAP_sample']:.4f} "
              f"integrate={res['final_mAP_integrate']:.4f}", flush=True)

    out = dict(results=results, out=args.out, delta=None, record=None)
    if len(results) == 2:
        md = os.path.join(args.out, "aug_chain_ab.md")
        out.update(delta=write_record(md, args, results), record=md)
        print(f"delta mAP (device - host): {out['delta']:+.4f}  -> {md}", flush=True)
    return out


if __name__ == "__main__":
    main()
