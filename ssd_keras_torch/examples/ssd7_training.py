"""Train SSD7 from scratch on a CSV-annotated dataset (e.g. Udacity traffic).

Port of the JAX package's ``examples/ssd7_training.py``: SSD7 at 300x480,
Adam 1e-3, the constant-input-size augmentation chain on the host, batch 16,
EarlyStopping + ReduceLROnPlateau + checkpoints + CSV logging. The targets
are encoded on the model's device.

Usage:
  python -m ssd_keras_torch.examples.ssd7_training \
      --images_dir ./udacity_driving_datasets \
      --train_labels ./udacity_driving_datasets/labels_train.csv \
      --val_labels ./udacity_driving_datasets/labels_val.csv \
      --epochs 20 --steps_per_epoch 1000
"""

from __future__ import annotations

import argparse

from ssd_keras_torch import SSDConfig, SSDInputEncoder, SSDLoss
from ssd_keras_torch import train as T
from ssd_keras_torch.data import DataGenerator
from ssd_keras_torch.data.chains import DataAugmentationConstantInputSize
from ssd_keras_torch.examples.common import add_device_args, device_of, dtype_of
from ssd_keras_torch.models import ssd_7


def main(argv=None):
    p = argparse.ArgumentParser(description="SSD7 training on a CSV dataset")
    p.add_argument("--images_dir", required=True)
    p.add_argument("--train_labels", required=True)
    p.add_argument("--val_labels", default=None)
    p.add_argument("--img_height", type=int, default=300)
    p.add_argument("--img_width", type=int, default=480)
    p.add_argument("--n_classes", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--checkpoint_dir", default="./checkpoints_ssd7")
    p.add_argument("--csv_log", default="./ssd7_training_log.csv")
    add_device_args(p, compute_dtype="float32")
    args = p.parse_args(argv)

    device = device_of(args)
    config = SSDConfig.ssd7(n_classes=args.n_classes, img_height=args.img_height,
                            img_width=args.img_width)
    model, predictor_sizes = ssd_7(config, mode="training", compute_dtype=dtype_of(args),
                                   device=device)
    encoder = SSDInputEncoder(config, predictor_sizes, device=device)

    input_format = ["image_name", "xmin", "xmax", "ymin", "ymax", "class_id"]
    train_ds = DataGenerator(load_images_into_memory=False, jpeg_device=device)
    train_ds.parse_csv(args.images_dir, args.train_labels, input_format)
    print(f"train images: {train_ds.get_dataset_size()}")

    augmentation = DataAugmentationConstantInputSize(
        random_brightness=(-48, 48, 0.5),
        random_contrast=(0.5, 1.8, 0.5),
        random_saturation=(0.5, 1.8, 0.5),
        random_hue=(18, 0.5),
        random_flip=0.5,
        random_translate=((0.03, 0.5), (0.03, 0.5), 0.5),
        random_scale=(0.5, 2.0, 0.5),
    )
    train_gen = train_ds.generate(
        batch_size=args.batch_size,
        shuffle=True,
        transformations=[augmentation],
        label_encoder=encoder,
        returns=["processed_images", "encoded_labels"],
    )

    val_gen, validation_steps = None, 0
    if args.val_labels:
        val_ds = DataGenerator(load_images_into_memory=False, jpeg_device=device)
        val_ds.parse_csv(args.images_dir, args.val_labels, input_format)
        val_gen = val_ds.generate(
            batch_size=args.batch_size,
            shuffle=False,
            transformations=[],
            label_encoder=encoder,
            returns=["processed_images", "encoded_labels"],
        )
        validation_steps = max(1, val_ds.get_dataset_size() // args.batch_size)

    optimizer = T.adam(model.parameters(), args.learning_rate)
    train_step = T.make_train_step(model, optimizer, SSDLoss(), l2_reg=0.0)
    eval_step = T.make_eval_step(model, SSDLoss())
    trainer = T.Trainer(model, optimizer, train_step, eval_step, base_lr=args.learning_rate)

    monitor = "val_loss" if val_gen else "loss"
    callbacks = [
        T.ModelCheckpoint(args.checkpoint_dir, monitor=monitor),
        T.CSVLogger(args.csv_log),
        T.EarlyStopping(monitor=monitor, patience=10),
        T.ReduceLROnPlateau(monitor=monitor, factor=0.2, patience=8),
        T.TerminateOnNaN(),
    ]
    history = trainer.fit_generator(
        train_gen,
        steps_per_epoch=args.steps_per_epoch,
        epochs=args.epochs,
        callbacks=callbacks,
        val_generator=val_gen,
        validation_steps=validation_steps,
    )
    print("final loss:", history["loss"][-1])
    if trainer.terminated_on_nan:
        raise SystemExit("training diverged (non-finite loss); exiting non-zero")
    return history


if __name__ == "__main__":
    main()
