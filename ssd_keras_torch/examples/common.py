"""What the examples share: the Pascal-VOC class names, the device, dtype
and weight arguments, checkpoint lookup, image reading and the NMS-launch
line."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ssd_keras_torch.devices import target_device
from ssd_keras_torch.kernels import nms as nms_kernel
from ssd_keras_torch.weights_io import load_keras_h5_weights

__all__ = [
    "VOC_CLASSES",
    "add_device_args",
    "add_weight_args",
    "checkpoint_step",
    "device_of",
    "dtype_of",
    "latest_checkpoint",
    "load_weights",
    "read_images",
    "print_nms_launches",
]

VOC_CLASSES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def add_device_args(parser, compute_dtype: Optional[str] = "bfloat16") -> None:
    """``--device`` (default ``cuda``: without a card the example raises)
    and, unless ``compute_dtype`` is None, ``--compute_dtype`` with that
    default."""
    parser.add_argument("--device", default="cuda",
                        help="where the model runs: cuda (default) or cpu")
    if compute_dtype is not None:
        parser.add_argument("--compute_dtype", default=compute_dtype, choices=sorted(DTYPES))


def add_weight_args(parser) -> None:
    parser.add_argument("--weights", default=None,
                        help=".h5 weights, loaded by layer name (needs h5py)")
    parser.add_argument("--checkpoint", default=None,
                        help="a port checkpoint (Trainer.save_checkpoint's ckpt_N.pt), or a "
                             "directory of them: the newest is used")


def device_of(args) -> torch.device:
    return target_device(args.device)


def dtype_of(args) -> torch.dtype:
    return DTYPES[args.compute_dtype]


def checkpoint_step(name: str) -> int:
    """The step or epoch of a ``ckpt_{n}`` or ``ckpt_{n}.pt`` name (so
    ``ckpt_10`` outranks ``ckpt_9``); -1 for any other name."""
    stem = name[:-3] if name.endswith(".pt") else name
    try:
        return int(stem.rsplit("_", 1)[-1]) if stem.startswith("ckpt_") else -1
    except ValueError:
        return -1


def latest_checkpoint(path: str) -> str:
    """``path`` if it is a file, else the newest ``ckpt_{n}.pt`` in it."""
    if os.path.isfile(path):
        return path
    names = [n for n in os.listdir(path) if n.endswith(".pt") and checkpoint_step(n) >= 0]
    if not names:
        raise SystemExit(f"no ckpt_*.pt checkpoints under {path}")
    return os.path.join(path, max(names, key=checkpoint_step))


def load_weights(model: torch.nn.Module, weights: Optional[str] = None,
                 checkpoint: Optional[str] = None) -> Optional[str]:
    """Load ``weights`` (a Keras ``.h5``, by layer name) or ``checkpoint``
    (a port checkpoint file or directory) into ``model``; returns what was
    loaded, or None when neither is given."""
    if weights:
        loaded = load_keras_h5_weights(weights, model)
        print(f"loaded {len(loaded)} layers")
        return weights
    if checkpoint:
        path = latest_checkpoint(checkpoint)
        device = next(model.parameters()).device
        state = torch.load(path, map_location=device, weights_only=True)["model"]
        model.load_state_dict(state)
        print(f"loaded {path} ({len(state)} tensors)")
        return path
    return None


def read_images(paths: Sequence[str], size: Tuple[int, int]) -> Tuple[np.ndarray, List]:
    """RGB images from files, resized to ``size`` (width, height) as PIL
    resizes them by default; returns the f32 batch and each original
    (width, height)."""
    from PIL import Image

    batch, orig_sizes = [], []
    for path in paths:
        with Image.open(path) as img:
            img = img.convert("RGB")
            orig_sizes.append(img.size)
            batch.append(np.array(img.resize(size), dtype=np.float32))
    return np.stack(batch), orig_sizes


def print_nms_launches() -> None:
    """How often this process launched the greedy-NMS CUDA kernel (0 on the
    CPU, where the plain version runs)."""
    print(f"NMS kernel launches: {nms_kernel.launches}")
