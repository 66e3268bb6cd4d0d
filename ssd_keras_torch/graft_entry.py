"""The port's graft entry points: the single-card forward check and the
multi-rank dry run.

Port of ``__graft_entry__.py``:

* :func:`entry` returns ``(forward, (model, x))``: SSD300 at full width in
  'training' mode (VGG-16 with the dilated fc6/fc7, the extra layers,
  conv4_3's L2Normalization, the six fused heads, the f32 softmax and the
  anchor concat; no decode), bf16 compute, weights drawn from seed 0, and a
  batch of eight 300x300 images with the JAX entry's exact bytes.
  ``forward(model, x)`` is ``model(x)``, (8, 8732, 33); the caller chooses
  the grad mode, as JAX's ``forward`` is a pure, differentiable function.
* On the card the counterpart of JAX's compile of ``forward`` is a CUDA
  graph of it, :class:`CapturedForward`, captured as the predictor captures
  its own (``utils.cuda_graph.CapturedGraph``).
* :func:`dryrun_multichip` is ``parallel.dryrun.dryrun_multichip``;
  ``python -m ssd_keras_torch.graft_entry`` runs it with ``N_DEVICES`` ranks
  (default 8) as gloo ranks on the CPU, as the JAX dry run pins its CPU
  backend.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.devices import target_device
from ssd_keras_torch.models import ssd_300
from ssd_keras_torch.parallel.dryrun import dryrun_multichip
from ssd_keras_torch.utils.cuda_graph import CapturedGraph

__all__ = ["entry", "entry_model", "example_batch", "forward", "CapturedForward",
           "dryrun_multichip", "BATCH"]

BATCH = 8


def example_batch(batch: int = BATCH) -> np.ndarray:
    """The JAX entry's input: ``RandomState(0).rand(batch, 300, 300, 3)`` in
    float32, times 255."""
    return np.random.RandomState(0).rand(batch, 300, 300, 3).astype(np.float32) * 255


def entry_model(device="cuda", compute_dtype: torch.dtype = torch.bfloat16) -> torch.nn.Module:
    """The entry's SSD300 ('training' mode, weights from seed 0) on
    ``device``, computing in ``compute_dtype``; no card raises."""
    model, _ = ssd_300(SSDConfig.ssd300(), mode="training", compute_dtype=compute_dtype,
                       device=device, generator=torch.Generator().manual_seed(0))
    return model


def forward(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The raw prediction tensor: class softmax, box offsets and anchors."""
    return model(x)


def entry(device="cuda"):
    """``(forward, (model, x))`` on ``device``: the card unless the caller
    asks for the CPU; with no card, ``device="cuda"`` raises before anything
    is built."""
    device = target_device(device)
    model = entry_model(device)
    x = torch.from_numpy(example_batch()).to(device)
    return forward, (model, x)


class CapturedForward(CapturedGraph):
    """``forward(model, x)`` captured as a CUDA graph over a static copy of
    ``x`` (``utils.cuda_graph.CapturedGraph``): its warm-up fills the
    model's kept bf16 weight copies and device constants, and the graph
    keeps the model's ``graph_inputs`` alive. Change no weight while it
    lives. A call copies ``x`` in (if given), replays on the current
    stream, counts the launches the graph holds, and returns a copy of the
    output."""

    def __init__(self, forward, model: torch.nn.Module, x: torch.Tensor):
        if x.device.type != "cuda":
            raise ValueError(f"a CUDA graph takes a CUDA input, got one on {x.device}")
        with torch.inference_mode():
            static_in = x.clone()
        super().__init__(lambda t: forward(model, t), static_in, torch.cuda.Stream(x.device),
                         lambda: model.graph_inputs(x.device))


if __name__ == "__main__":
    n = int(os.environ.get("N_DEVICES", "8"))
    reports = dryrun_multichip(n)
    print(f"dryrun_multichip OK: {n} gloo ranks on the CPU, "
          f"loss {reports[0]['loss']:.4f}, resident {reports[0]['loss_resident']:.4f}, "
          f"streamed {reports[0]['loss_streamed']:.4f}")
