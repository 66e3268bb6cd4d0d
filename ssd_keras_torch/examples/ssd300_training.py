"""Train SSD300 on Pascal VOC 07+12 with the original SSD recipe.

Port of the JAX package's ``examples/ssd300_training.py``: VGG-16 backbone
(optionally from a ``.h5`` by layer name), the Caffe-faithful augmentation
chain on the host, SGD momentum 0.9 / L2 5e-4, the LR schedule 1e-3 -> 1e-4 at
epoch 80 -> 1e-5 at epoch 100, batch 32, 120 epochs x 1000 steps.

Beyond the reference:
  --device_pipeline   augmentation and target encoding on the card; the host
                      only decodes and resizes each image once. The split is
                      kept on the card as uint8 (``--hbm_dataset_gb`` bounds
                      it), or streamed through pinned double-buffered uploads
                      when it is larger.
  --data_parallel     one process a card, each on its rows of every global
                      batch. Rank and world size come from the environment
                      as ``torchrun`` sets them (one rank without it); NCCL
                      on the card, gloo on the CPU.

Usage:
  python -m ssd_keras_torch.examples.ssd300_training \
      --voc_root ./VOCdevkit --weights ./VGG_ILSVRC_16_layers_fc_reduced.h5
  torchrun --nproc_per_node 4 -m ssd_keras_torch.examples.ssd300_training \
      --voc_root ./VOCdevkit --device_pipeline --data_parallel
"""

from __future__ import annotations

import argparse
import os
import random
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ssd_keras_torch import SSDConfig, SSDInputEncoder, SSDLoss
from ssd_keras_torch import train as T
from ssd_keras_torch.data import DataGenerator
from ssd_keras_torch.data.chains import SSDDataAugmentation
from ssd_keras_torch.data.device_aug import DeviceSSDAugmentation, batch_seed
from ssd_keras_torch.data.geometric import Resize
from ssd_keras_torch.data.photometric import ConvertTo3Channels
from ssd_keras_torch.data.streaming import StreamingDeviceInput, host_decode_batches
from ssd_keras_torch.examples.common import (
    VOC_CLASSES,
    add_device_args,
    add_weight_args,
    device_of,
    dtype_of,
    load_weights,
)
from ssd_keras_torch.models import ssd_300
from ssd_keras_torch.parallel import sharding as sh

SEED = 0


def lr_schedule(epoch: int) -> float:
    """The canonical step schedule (ssd300_training.ipynb cell 14)."""
    if epoch < 80:
        return 1e-3
    if epoch < 100:
        return 1e-4
    return 1e-5


def voc_datasets(voc_root, splits_train, splits_val, jpeg_device="cuda"):
    def build(split_list):
        ds = DataGenerator(load_images_into_memory=False, jpeg_device=jpeg_device)
        images_dirs, sets, anns = [], [], []
        for year, split in split_list:
            base = os.path.join(voc_root, f"VOC{year}")
            images_dirs.append(os.path.join(base, "JPEGImages"))
            sets.append(os.path.join(base, "ImageSets", "Main", f"{split}.txt"))
            anns.append(os.path.join(base, "Annotations"))
        ds.parse_xml(images_dirs, sets, anns, classes=VOC_CLASSES)
        return ds

    return build(splits_train), build(splits_val)


def init_data_parallel(device: torch.device):
    """Join the ranks' process group as ``torchrun`` describes it in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), or as the one rank of a group of one without it.
    Returns (the rank's device, the mesh)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ:
        sh.initialize_distributed(backend, world, rank, init_method="env://")
    elif world == 1:
        store_dir = tempfile.mkdtemp()
        sh.initialize_distributed(backend, 1, 0,
                                  store=dist.FileStore(os.path.join(store_dir, "store"), 1))
    else:
        raise RuntimeError(f"WORLD_SIZE={world} without MASTER_ADDR: launch with torchrun")
    return device, sh.make_mesh(device.type)


def host_split(ds, max_gt_boxes, batch=64):
    """One ordered host pass over a split: decoded and resized uint8 images,
    padded labels and counts."""
    n = ds.get_dataset_size()
    images, padded, counts = [], [], []
    batches = host_decode_batches(ds, batch, 300, 300, max_gt_boxes, shuffle=False)
    while sum(len(c) for c in counts) < n:
        x, p, c = next(batches)
        images.append(x)
        padded.append(p)
        counts.append(c)
    return tuple(np.concatenate(a)[:n] for a in (images, padded, counts))


def main(argv=None):
    p = argparse.ArgumentParser(description="SSD300 training on Pascal VOC 07+12")
    p.add_argument("--voc_root", required=True)
    add_weight_args(p)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--initial_epoch", type=int, default=0)
    p.add_argument("--resume", default=None, help="a port checkpoint to resume from")
    p.add_argument("--device_pipeline", action="store_true")
    p.add_argument("--data_parallel", action="store_true")
    p.add_argument("--checkpoint_dir", default="./checkpoints_ssd300")
    p.add_argument("--csv_log", default="./ssd300_training_log.csv")
    p.add_argument("--base_lr", type=float, default=1e-3,
                   help="peak LR; the canonical 1e-3 assumes pretrained VGG "
                        "weights -- from random init use ~1e-4 with --clipnorm")
    p.add_argument("--clipnorm", type=float, default=None,
                   help="global-norm gradient clipping (e.g. 5)")
    p.add_argument("--hbm_dataset_gb", type=float, default=6.0,
                   help="--device_pipeline keeps the decoded uint8 train split on "
                        "the card; past this many GiB per card it is streamed")
    p.add_argument("--warmup", type=int, default=0,
                   help="linear LR warmup steps to base_lr: the from-random-init "
                        "stand-in for the reference's pretrained-VGG start")
    add_device_args(p)
    args = p.parse_args(argv)

    device = device_of(args)
    mesh = None
    if args.data_parallel:
        device, mesh = init_data_parallel(device)
    n_dev = 1 if mesh is None else mesh.size()
    if args.batch_size % n_dev:
        raise SystemExit(f"--batch_size {args.batch_size} does not divide over {n_dev} ranks")
    local_batch = args.batch_size // n_dev
    rank = 0 if mesh is None else mesh.get_local_rank()

    config = SSDConfig.ssd300(n_classes=20)
    model, predictor_sizes = ssd_300(config, mode="training", compute_dtype=dtype_of(args),
                                     device=device)
    encoder = SSDInputEncoder(config, predictor_sizes, device=device)

    train_ds, val_ds = voc_datasets(
        args.voc_root,
        splits_train=[("2007", "trainval"), ("2012", "trainval")],
        splits_val=[("2007", "test")],
        jpeg_device=device,
    )
    print(f"train: {train_ds.get_dataset_size()}  val: {val_ds.get_dataset_size()}")
    validation_steps = max(1, val_ds.get_dataset_size() // args.batch_size)

    def rank_rows(batch):
        """This rank's rows of a global batch (every rank makes the same one)."""
        return batch if mesh is None else sh.shard_batch(batch, mesh)

    if args.device_pipeline:
        # Host: decode + one fixed-size resize per image. Card: augmentation,
        # encoding and the step. Under a mesh each rank keeps its rows of the
        # split and the batch gather moves rows between ranks.
        device_aug = DeviceSSDAugmentation(300, 300, mesh=mesh)
        est_gb = train_ds.get_dataset_size() * 300 * 300 * 3 / 2**30 / n_dev
        if est_gb > args.hbm_dataset_gb:
            print(f"train split ~{est_gb:.1f} GiB uint8 per card exceeds "
                  f"--hbm_dataset_gb {args.hbm_dataset_gb}; streaming the "
                  "device pipeline (double-buffered uint8 uploads)")
            train_generator = iter(StreamingDeviceInput(
                host_decode_batches(train_ds, local_batch, 300, 300, encoder.max_gt_boxes,
                                    shard_index=rank, num_shards=n_dev, seed=SEED),
                device_aug, encoder, seed=SEED))
        else:
            split = host_split(train_ds, encoder.max_gt_boxes)
            n = len(split[0]) // n_dev * n_dev  # the sharded rows must divide evenly
            if mesh is None:
                resident = [torch.from_numpy(a).to(device) for a in split]
            else:
                resident = [sh.upload_sharded(a[:n], mesh, device) for a in split]
            print(f"card-resident train split: {n} images "
                  f"({split[0][:n].nbytes / 2**30 / n_dev:.2f} GiB uint8 per card x {n_dev})")
            del split

            def gather(idx):
                if mesh is None:
                    idx = torch.from_numpy(idx).to(device)
                    return tuple(a[idx] for a in resident)
                return sh.exchange_rows(resident, idx, mesh)

            def train_gen():
                rng = np.random.RandomState(SEED)
                order, ptr, i = rng.permutation(n), 0, 0
                while True:
                    if ptr + args.batch_size > len(order):
                        order, ptr = rng.permutation(n), 0
                    imgs, lbls, counts = device_aug(
                        batch_seed(SEED, i), *gather(order[ptr:ptr + args.batch_size]))
                    ptr += args.batch_size
                    i += 1
                    yield imgs, encoder.encode_padded(lbls, counts)

            train_generator = train_gen()

        # Validation batches live on the card too: the rank's rows as uint8
        # and their targets encoded once.
        v_imgs, v_padded, v_counts = host_split(val_ds, encoder.max_gt_boxes)
        val_batches = []
        for i in range(0, validation_steps * args.batch_size, args.batch_size):
            x, lp, lc = rank_rows(tuple(a[i:i + args.batch_size]
                                        for a in (v_imgs, v_padded, v_counts)))
            val_batches.append((torch.as_tensor(x).to(device), encoder.encode_padded(lp, lc)))
        del v_imgs, v_padded, v_counts

        def val_gen():
            while True:
                yield from val_batches

        val_generator = val_gen()
    else:
        # Every rank draws the same global batches and keeps its rows.
        np.random.seed(SEED)
        random.seed(SEED)
        train_generator = map(rank_rows, train_ds.generate(
            batch_size=args.batch_size,
            shuffle=True,
            transformations=[SSDDataAugmentation(img_height=300, img_width=300)],
            label_encoder=encoder,
            returns=["processed_images", "encoded_labels"],
        ))
        val_generator = map(rank_rows, val_ds.generate(
            batch_size=args.batch_size,
            shuffle=False,
            transformations=[ConvertTo3Channels(), Resize(300, 300)],
            label_encoder=encoder,
            returns=["processed_images", "encoded_labels"],
        ))

    load_weights(model, args.weights, args.checkpoint)
    if mesh is not None:
        sh.replicate(model, mesh)
    lr = T.linear_warmup_lr(args.base_lr, args.warmup) if args.warmup > 0 else args.base_lr
    optimizer = T.sgd_with_momentum(model.parameters(), lr, momentum=0.9,
                                    clipnorm=args.clipnorm)
    train_step = T.make_train_step(model, optimizer, SSDLoss(), l2_reg=5e-4, mesh=mesh)
    eval_step = T.make_eval_step(model, SSDLoss(), mesh=mesh)
    trainer = T.Trainer(model, optimizer, train_step, eval_step, base_lr=args.base_lr,
                        mesh=mesh)
    if args.resume:
        trainer.restore_checkpoint(args.resume)

    callbacks = [
        T.ModelCheckpoint(args.checkpoint_dir, monitor="val_loss", save_best_only=True),
        T.CSVLogger(args.csv_log, append=args.initial_epoch > 0),
        T.TerminateOnNaN(),
    ]
    try:
        history = trainer.fit_generator(
            train_generator,
            steps_per_epoch=args.steps_per_epoch,
            epochs=args.epochs,
            callbacks=callbacks,
            val_generator=val_generator,
            validation_steps=validation_steps,
            initial_epoch=args.initial_epoch,
            # schedule(e)/1e-3 is the canonical step *shape* (1 -> 0.1 -> 0.01);
            # trainer.base_lr (= --base_lr) scales it to the chosen peak.
            lr_schedule=lr_schedule,
            base_lr=1e-3,
        )
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if trainer.terminated_on_nan:
        raise SystemExit("training diverged (non-finite loss); exiting non-zero")
    return history


if __name__ == "__main__":
    main()
