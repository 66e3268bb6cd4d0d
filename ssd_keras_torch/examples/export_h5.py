"""Export a port training checkpoint as a Keras-layout ``.h5`` weight file.

Port of the JAX package's ``examples/export_h5.py``. The reference's weight
files are Keras ``save_weights`` ``.h5`` files keyed by layer name; this
turns a ``Trainer.save_checkpoint`` file (``ckpt_{n}.pt``) into one, so a
model trained here loads into the inference, evaluation and weight-sampling
workflows, and into the JAX package, as the reference's downloads do.
BatchNorm statistics (SSD7) ride along.

Usage:
  python -m ssd_keras_torch.examples.export_h5 --model ssd512 \
      --checkpoint /tmp/synthvoc_ckpt --out /tmp/ssd512_trained.h5
"""

from __future__ import annotations

import argparse

import torch

from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.examples.common import latest_checkpoint
from ssd_keras_torch.models import ssd_7, ssd_300, ssd_512
from ssd_keras_torch.weights_io import save_keras_h5_weights


def main(argv=None):
    p = argparse.ArgumentParser(description="port checkpoint -> Keras .h5")
    p.add_argument("--model", choices=["ssd300", "ssd512", "ssd7"], required=True)
    p.add_argument("--n_classes", type=int, default=20)
    p.add_argument("--img_height", type=int, default=None,
                   help="SSD7 only (SSD300/512 are fixed-size)")
    p.add_argument("--img_width", type=int, default=None)
    p.add_argument("--checkpoint", required=True,
                   help="a ckpt_{n}.pt file, or a directory of them (the newest is used)")
    p.add_argument("--out", required=True, help="output .h5 path")
    args = p.parse_args(argv)

    path = latest_checkpoint(args.checkpoint)
    if args.model == "ssd7":
        sizes = {k: v for k, v in (("img_height", args.img_height),
                                   ("img_width", args.img_width)) if v is not None}
        model, _ = ssd_7(SSDConfig.ssd7(n_classes=args.n_classes, **sizes), device="cpu")
    else:
        build = ssd_300 if args.model == "ssd300" else ssd_512
        model, _ = build(n_classes=args.n_classes, device="cpu")
    # The checkpoint's tensors carry the reference's layer names, which the
    # .h5 keeps; the weights' shapes, not the image size, must match.
    state = torch.load(path, map_location="cpu", weights_only=True)["model"]
    model.load_state_dict(state)
    save_keras_h5_weights(args.out, model)
    print(f"exported {args.out} from {path} ({len(state)} tensors)")


if __name__ == "__main__":
    main()
