"""What the examples share: the Pascal-VOC class names, the device, dtype
and weight arguments, checkpoint lookup, image reading, the NMS-launch
line and the card's name and power limit."""

from __future__ import annotations

import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.devices import target_device
from ssd_keras_torch.models import ssd_300
from ssd_keras_torch.utils.profiling import counters
from ssd_keras_torch.weights_io import load_keras_h5_weights

__all__ = [
    "VOC_CLASSES",
    "add_device_args",
    "add_weight_args",
    "card_line",
    "checkpoint_step",
    "device_of",
    "dtype_of",
    "latest_checkpoint",
    "load_weights",
    "read_images",
    "scale_to_trained_range",
    "seeded_ssd300",
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
    print(f"NMS kernel launches: {counters().get('nms.launches', 0)}")


def card_line(device) -> str:
    """The card of ``device`` as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives it (a record's speed is read against the
    card's power limit); ``cpu`` for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None else device.index
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out.splitlines()[0]


def scale_to_trained_range(model: torch.nn.Module) -> torch.nn.Module:
    """Scale an SSD300's or SSD512's seeded weights in place so that its
    outputs sit in a trained detector's range, and return it. Raw He init
    carries the 0-255 input's magnitude (~75 RMS) through the trunk, which
    saturates the softmax at exactly 1.0 and overflows the box exponent:
    conv1_1 at 1/100 brings the logits to O(1). The loc heads at 1/4 then
    give encoded offsets of ~0.4 RMS, so every decoded box stays near its
    anchor, as a trained model's do."""
    with torch.no_grad():
        model.conv1_1.weight.mul_(0.01)
        for name, module in model.named_children():
            if name.endswith("_mbox_loc"):
                module.weight.mul_(0.25)
    return model


def seeded_ssd300(mode: str, dtype: torch.dtype, device, config: Optional[SSDConfig] = None,
                  seed: int = 0) -> torch.nn.Module:
    """SSD300 (Pascal VOC unless ``config``) from the seeded init, scaled by
    :func:`scale_to_trained_range`, on ``device``."""
    device = target_device(device)
    model, _ = ssd_300(config or SSDConfig.ssd300(), mode=mode, compute_dtype=dtype,
                       device="cpu", generator=torch.Generator().manual_seed(seed))
    return scale_to_trained_range(model).to(device)
