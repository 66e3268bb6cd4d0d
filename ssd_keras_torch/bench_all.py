"""Extended benchmark: every model family, mode and pipeline stage on one CUDA card.

Port of the JAX package's ``bench_all.py``: the reference's FPS table
(SSD300, SSD512 and SSD7 at batch 1 and 8, with ``vs_baseline`` against the
GTX 1070 figures) and the stages the reference cannot measure (BatchNorm
folding, COCO's class count, the decode, the serving predictor, the train
step, the device input pipeline), under the JAX script's row names and in
its order, with its keys. Two of its rows change:

* ``ssd300 fwd+decode(topk=approx) batch 8`` is left out: ``approx_max_k``
  is a TPU workaround the port does not have.
* The four ``... on-device chained`` rows read ``... device time``. They
  give the card's own time of one call, as those gave the chip's: the call
  captured as a CUDA graph (``SSDPredictor``'s per-shape graph, the batch
  already on the card) and replayed under ``utils.profiling.time_calls``,
  which holds the card while the host enqueues. A replay is one launch, so
  the enqueue stays far inside the launch queue.

Each row's work is built by a function that takes the model's
configuration (``inference_work``, ``folded_work``, ``fwd_decode_work``,
``predictor_stream_work``, ``device_resident_work``, ``train_step_work``,
``augment_encode_work``), so the same code runs at any size. Compute is
bf16 over f32 weights, as in the JAX script. Weights come from the port's
seeded init (seed 0); SSD300's and SSD512's are scaled into a trained
detector's range (``examples.common.scale_to_trained_range``), so the decode
does a served batch's work (raw He init saturates the softmax). Images are
seeded random numbers.

Timers, each row's ``timer``: ``benchmark_fps`` rows are ``n_iters`` calls
back to back between CUDA events (the host's launches count where they are
slower than the card), best of 3 repeats; ``device time`` rows are the
least of 3 ``time_calls`` repeats; the 64-image stream is the host clock
around whole requests (best of 3), host upload and download included; the
train step and augment + encode are CUDA events around ``n_iters`` calls
after one warm-up, with one read of the result at the end. On the CPU the
host clock times the same work. ``nms_launches`` is how often the greedy-NMS
kernel ran during the row; on the card every row that decodes must launch
it, or the script raises. The device augmentation draws from its own
``torch.Generator`` seeded with the loop index, where the JAX script folds
the index into a JAX key: the same distributions, other draws.

Usage: python -m ssd_keras_torch.bench_all [--quick] [--out FILE] [--device cuda|cpu]
Writes the matrix (JSON) to ``--out`` (under the temp dir by default, never
the JAX package's ``BENCH_MATRIX.json``), prints a line per row as it goes,
then the rows as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ssd_keras_torch import SSDConfig, SSDInputEncoder, SSDLoss, SSDPredictor
from ssd_keras_torch import train as T
from ssd_keras_torch.data.device_aug import DeviceSSDAugmentation
from ssd_keras_torch.decoder import decode_detections_fixed
from ssd_keras_torch.devices import target_device
from ssd_keras_torch.examples.common import add_device_args, card_line, scale_to_trained_range
from ssd_keras_torch.models import (ssd7_predictor_sizes, ssd300_predictor_sizes,
                                    ssd512_predictor_sizes, ssd_7, ssd_300, ssd_512)
from ssd_keras_torch.optimize import fold_batchnorm
from ssd_keras_torch.utils.profiling import benchmark_fps, counters, time_calls

__all__ = ["BASELINE_FPS", "MATRIX", "Row", "augment_encode_work", "build",
           "device_resident_work", "families", "folded_work", "fwd_decode_work",
           "inference_work", "main", "predictor_stream_work", "row_names", "seeded_state",
           "stream_images", "synthetic_targets", "train_step_work"]

# Reference FPS on GTX 1070 (the reference README's table), keyed by (model, batch).
BASELINE_FPS = {
    ("ssd300", 1): 39.0, ("ssd300", 8): 49.0,
    ("ssd512", 1): 20.0, ("ssd512", 8): 25.0,
    ("ssd7", 1): 127.0, ("ssd7", 8): 216.0,
}

ARCHS = {"ssd300": (ssd_300, ssd300_predictor_sizes),
         "ssd512": (ssd_512, ssd512_predictor_sizes),
         "ssd7": (ssd_7, ssd7_predictor_sizes)}
DTYPE = torch.bfloat16  # the compute; parameters stay f32
REPEATS = 3
SEED = 0
STREAM_IMAGES, STREAM_HW, STREAM_BATCH = 64, (480, 640), 8
TRAIN_BATCH = 32
MAX_GT_BOXES = 32


def families() -> Dict[str, Tuple[str, SSDConfig]]:
    """The matrix's model families: name -> (architecture, configuration)."""
    return {
        "ssd300": ("ssd300", SSDConfig.ssd300()),
        "ssd512": ("ssd512", SSDConfig.ssd512()),
        "ssd7": ("ssd7", SSDConfig.ssd7(img_height=300, img_width=480)),
        "coco": ("ssd300", SSDConfig.ssd300(n_classes=80, dataset="coco")),
    }


# --- The work of each row, built from a configuration -----------------------

def build(arch: str, config: SSDConfig, mode: str, dtype: torch.dtype, device,
          state: Optional[Dict[str, torch.Tensor]] = None, fold_bn: bool = False):
    """``arch`` in ``mode`` on ``device`` holding ``state``, or when None the
    seeded weights (SEED; SSD300's and SSD512's scaled into a trained
    detector's range). Returns ``(module, predictor_sizes)``."""
    device = target_device(device)
    kwargs = dict(fold_bn=True) if fold_bn else {}
    model, sizes = ARCHS[arch][0](config, mode=mode, compute_dtype=dtype, device="cpu",
                                  generator=torch.Generator().manual_seed(SEED), **kwargs)
    if state is not None:
        model.load_state_dict(state)
    elif arch != "ssd7":
        scale_to_trained_range(model)
    return model.to(device), sizes


def seeded_state(arch: str, config: SSDConfig) -> Dict[str, torch.Tensor]:
    """``arch``'s seeded weights as :func:`build` makes them (f32, CPU)."""
    return build(arch, config, "training", torch.float32, "cpu")[0].state_dict()


def random_images(batch: int, config: SSDConfig, device, seed: int = SEED) -> torch.Tensor:
    """(batch, H, W, 3) f32 in [0, 255) on ``device``."""
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, config.img_height, config.img_width, 3).astype(np.float32) * 255
    return torch.from_numpy(x).to(target_device(device))


def inference_work(arch, config, mode, batch, dtype, device, state=None):
    """(model, x): ``arch`` in ``mode`` (decode included) and ``batch`` images."""
    model, _ = build(arch, config, mode, dtype, device, state)
    return model, random_images(batch, config, device)


def folded_work(config, batch, dtype, device, state=None):
    """(model, x): SSD7 'inference' with its BatchNorms folded into the convs
    (``optimize.fold_batchnorm`` of ``state``, the seeded weights when None)."""
    folded = fold_batchnorm(seeded_state("ssd7", config) if state is None else state)
    model, _ = build("ssd7", config, "inference", dtype, device, folded, fold_bn=True)
    return model, random_images(batch, config, device)


def fwd_decode_work(arch, config, batch, dtype, device, state=None):
    """(forward, x): the 'training' model, then ``decode_detections_fixed``
    (exact top-k) of its y_pred."""
    model, _ = build(arch, config, "training", dtype, device, state)

    def forward(x):
        return decode_detections_fixed(model(x), img_height=config.img_height,
                                       img_width=config.img_width)

    return forward, random_images(batch, config, device)


def stream_images(n: int, hw: Tuple[int, int] = STREAM_HW) -> List[np.ndarray]:
    """``n`` uint8 (H, W, 3) frames, frame i from ``RandomState(i)``."""
    return [np.random.RandomState(i).randint(0, 255, (*hw, 3), np.uint8) for i in range(n)]


def predictor_stream_work(arch, config, dtype, device, state=None):
    """(predictor, frames): an 'inference' model behind ``SSDPredictor`` at
    batch 8, and the stream's 64 640x480 frames."""
    model, _ = build(arch, config, "inference", dtype, device, state)
    return SSDPredictor(model, batch_size=STREAM_BATCH), stream_images(STREAM_IMAGES)


def device_resident_work(arch, config, dtype, device, state=None):
    """(run, batch): the predictor's program for 64 f32 640x480 frames (on the
    card its CUDA graph: resize, forward, decode) and those frames already on
    ``device``."""
    model, _ = build(arch, config, "inference", dtype, device, state)
    run = SSDPredictor(model, batch_size=STREAM_IMAGES)._fused_run(*STREAM_HW, np.float32)
    frames = np.stack(stream_images(STREAM_IMAGES)).astype(np.float32)
    return run, torch.from_numpy(frames).to(target_device(device))


def synthetic_targets(batch: int, n_boxes: int, n_classes_with_bg: int) -> np.ndarray:
    """The JAX script's y_true: background everywhere, and box ``37 b % N``
    of image b given class ``1 + b % (C - 1)`` (its ``1 + b % 20`` at VOC's
    21 classes)."""
    y = np.zeros((batch, n_boxes, n_classes_with_bg + 12), np.float32)
    y[:, :, 0] = 1
    for b in range(batch):
        y[b, 37 * b % n_boxes, 0] = 0
        y[b, 37 * b % n_boxes, 1 + b % (n_classes_with_bg - 1)] = 1
    return y


def train_step_work(arch, config, batch, dtype, device, state=None):
    """(step, x, y): ``train.make_train_step`` with ``sgd_with_momentum(1e-3)``,
    ``SSDLoss()`` and L2 5e-4, a batch of images and its synthetic targets."""
    model, sizes = build(arch, config, "training", dtype, device, state)
    opt = T.sgd_with_momentum(model.parameters(), 1e-3)
    step = T.make_train_step(model, opt, SSDLoss(), l2_reg=5e-4)
    y = synthetic_targets(batch, config.total_boxes(sizes), config.n_classes_with_background)
    y = torch.from_numpy(y).to(target_device(device))
    return step, random_images(batch, config, device), y


def augment_encode_work(arch, config, batch, device):
    """``pipe(i)``: ``DeviceSSDAugmentation`` seeded ``i`` of a fixed uint8
    batch with two boxes an image, then ``SSDInputEncoder.encode_padded``
    (max_gt_boxes 32) of its labels. Returns (images, y_true). The JAX
    script's boxes, given for 300x300, are scaled to the configuration's
    size."""
    device = target_device(device)
    h, w = config.img_height, config.img_width
    enc = SSDInputEncoder(config, ARCHS[arch][1](h, w), max_gt_boxes=MAX_GT_BOXES, device=device)
    aug = DeviceSSDAugmentation(h, w)
    images = np.random.RandomState(1).randint(0, 256, (batch, h, w, 3)).astype(np.uint8)
    labels = np.zeros((batch, MAX_GT_BOXES, 5), np.float32)
    labels[:, 0] = [1, 40, 50, 140, 180]
    labels[:, 1] = [2, 150, 30, 280, 200]
    labels[:, :2, 1::2] *= w / 300
    labels[:, :2, 2::2] *= h / 300
    images, labels = torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)
    n_valid = torch.full((batch,), 2, dtype=torch.int32, device=device)

    def pipe(i):
        out, new_labels, counts = aug(i, images, labels, n_valid)
        return out, enc.encode_padded(new_labels, counts)

    return pipe


# --- Timers ------------------------------------------------------------------

@dataclasses.dataclass
class Context:
    device: torch.device
    n_iters: int
    families: Dict[str, Tuple[str, SSDConfig]]


def _fps_row(forward, x, ctx: Context):
    r = benchmark_fps(forward, x, n_iters=ctx.n_iters, n_repeats=REPEATS)
    timer = ("cuda events, back to back" if ctx.device.type == "cuda" else "host clock (cpu)")
    return r["ms_per_batch"], r["fps"], timer


def _device_time_row(model, x, ctx: Context):
    """The card's time of one ``model(x)``, replayed from the predictor's
    CUDA graph (on the CPU the host clock of the eager call)."""
    run = SSDPredictor(model, batch_size=len(x))._fused_run(*x.shape[1:3], np.float32)
    ms = time_calls(lambda: run(x), ctx.device, iters=ctx.n_iters, repeats=REPEATS)["min"]
    timer = ("cuda events, card held, graph replay" if ctx.device.type == "cuda"
             else "host clock (cpu)")
    return ms, len(x) * 1e3 / ms, timer


def _loop_row(fn, read, batch: int, ctx: Context):
    """``n_iters`` calls ``fn(i)`` after one warm-up call, then ``read`` of the
    last result (the one wait for the device)."""
    read(fn(0))
    if ctx.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(ctx.n_iters):
            out = fn(i)
        end.record()
        read(out)
        end.synchronize()
        ms, timer = start.elapsed_time(end) / ctx.n_iters, "cuda events"
    else:
        t0 = time.perf_counter()
        for i in range(ctx.n_iters):
            out = fn(i)
        read(out)
        ms, timer = 1e3 * (time.perf_counter() - t0) / ctx.n_iters, "host clock (cpu)"
    return ms, batch * 1e3 / ms, timer


# --- The rows ----------------------------------------------------------------

def _inference(family, mode, batch, ctx):
    arch, config = ctx.families[family]
    return _fps_row(*inference_work(arch, config, mode, batch, DTYPE, ctx.device), ctx)


def _inference_device_time(family, batch, ctx):
    arch, config = ctx.families[family]
    return _device_time_row(*inference_work(arch, config, "inference", batch, DTYPE,
                                            ctx.device), ctx)


def _folded(batch, device_time, ctx):
    _, config = ctx.families["ssd7"]
    work = folded_work(config, batch, DTYPE, ctx.device)
    return (_device_time_row if device_time else _fps_row)(*work, ctx)


def _fwd_decode(ctx):
    arch, config = ctx.families["ssd300"]
    return _fps_row(*fwd_decode_work(arch, config, 8, DTYPE, ctx.device), ctx)


def _stream(ctx):
    arch, config = ctx.families["ssd300"]
    predictor, frames = predictor_stream_work(arch, config, DTYPE, ctx.device)
    predictor(frames[:STREAM_BATCH])  # the shape's first request makes its program
    best = None
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        predictor(frames)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    chunks = len(frames) / STREAM_BATCH
    return best / chunks * 1e3, len(frames) / best, "host clock, whole requests"


def _resident(ctx):
    arch, config = ctx.families["ssd300"]
    return _fps_row(*device_resident_work(arch, config, DTYPE, ctx.device), ctx)


def _train_step(ctx):
    arch, config = ctx.families["ssd300"]
    with torch.enable_grad():
        step, x, y = train_step_work(arch, config, TRAIN_BATCH, DTYPE, ctx.device)
        return _loop_row(lambda i: step(x, y), lambda m: float(m["loss"]), TRAIN_BATCH, ctx)


def _augment_encode(ctx):
    arch, config = ctx.families["ssd300"]
    pipe = augment_encode_work(arch, config, TRAIN_BATCH, ctx.device)
    return _loop_row(pipe, lambda out: float(out[1][0, 0, 0]), TRAIN_BATCH, ctx)


@dataclasses.dataclass(frozen=True)
class Row:
    """One row: its JAX name, what measures it (``ctx -> (ms_per_batch,
    img/s, timer)``), its reference baseline and whether it decodes (and so
    must launch the NMS kernel on the card)."""

    name: str
    measure: Callable[[Context], Tuple[float, float, str]]
    baseline: Optional[float] = None
    decodes: bool = True


def _matrix() -> List[Row]:
    rows = []
    for family in ("ssd300", "ssd512", "ssd7"):
        for mode in ("inference", "inference_fast"):
            # Batch 32 for ssd300 (the serving sweet spot where decode
            # amortizes) and ssd7 (tiny channel counts fill the card only at
            # large batches), as the JAX matrix has it.
            batches = ((1, 8, 32) if mode == "inference" and family in ("ssd300", "ssd7")
                       else (1, 8))
            for batch in batches:
                rows.append(Row(f"{family} {mode} batch {batch}",
                                functools.partial(_inference, family, mode, batch),
                                BASELINE_FPS.get((family, batch)) if mode == "inference"
                                else None))
    for batch in (1, 8, 32):
        rows.append(Row(f"ssd7 inference(bn-folded) batch {batch}",
                        functools.partial(_folded, batch, False),
                        BASELINE_FPS.get(("ssd7", batch))))
    for batch in (1, 8):
        rows.append(Row(f"ssd7 inference(bn-folded) batch {batch} device time",
                        functools.partial(_folded, batch, True), BASELINE_FPS[("ssd7", batch)]))
    rows += [
        Row("ssd300 inference batch 8 device time",
            functools.partial(_inference_device_time, "ssd300", 8), BASELINE_FPS[("ssd300", 8)]),
        Row("ssd300 COCO(81 classes) inference batch 8",
            functools.partial(_inference, "coco", "inference", 8)),
        Row("ssd300 COCO(81 classes) inference batch 8 device time",
            functools.partial(_inference_device_time, "coco", 8)),
        Row("ssd300 fwd+decode(topk=exact) batch 8", _fwd_decode, BASELINE_FPS[("ssd300", 8)]),
        Row("ssd300 SSDPredictor 640x480 inputs 64-image stream (incl. host upload)", _stream),
        Row("ssd300 SSDPredictor 640x480 device-resident 64-image batch", _resident),
        Row(f"ssd300 train step batch {TRAIN_BATCH}", _train_step, decodes=False),
        Row(f"device augment+encode batch {TRAIN_BATCH}", _augment_encode, decodes=False),
    ]
    return rows


MATRIX = _matrix()


def row_names() -> List[str]:
    """The 27 row names, in the order the matrix runs them."""
    return [row.name for row in MATRIX]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "ssd_keras_torch_bench_matrix.json"))
    add_device_args(p, compute_dtype=None)
    args = p.parse_args(argv)
    device = target_device(args.device)
    n_iters = 10 if args.quick else 25
    card = card_line(device)
    ctx = Context(device, n_iters, families())

    rows = []
    with torch.no_grad():
        for row in MATRIX:
            before = counters().get("nms.launches", 0)
            ms, fps, timer = row.measure(ctx)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            launches = counters().get("nms.launches", 0) - before
            if device.type == "cuda" and row.decodes and launches <= 0:
                raise AssertionError(f"{row.name}: the NMS kernel was never launched")
            baseline = row.baseline
            rows.append({
                "name": row.name, "ms_per_batch": round(ms, 3), "throughput": round(fps, 1),
                "baseline": baseline,
                "vs_baseline": round(fps / baseline, 2) if baseline else None,
                "timer": timer, "nms_launches": launches, "card": card,
            })
            speedup = f"  ({fps / baseline:.1f}x baseline)" if baseline else ""
            print(f"{row.name:<48} {ms:8.2f} ms {fps:9.0f} img/s{speedup}  [{card}]", flush=True)
            # Each row's models, graphs and batches go before the next one's.
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()

    artifact = {
        "device": card,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "n_iters": n_iters,
        "rows": rows,
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"\nwrote {args.out}  [{card}]")
    print(json.dumps(rows), flush=True)
    return artifact


if __name__ == "__main__":
    main()
