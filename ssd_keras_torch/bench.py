"""Benchmark: SSD300 end-to-end inference img/s on one CUDA card.

Port of the JAX package's ``bench.py``: the same quantity as the
reference's headline FPS benchmark (SSD300, batch 8, the 'inference' model
with its decode layer; 49 FPS on a GTX 1070) with ``vs_baseline`` against
that number, and the same environment variables: ``BENCH_BATCH`` (8),
``BENCH_DTYPE`` (``bfloat16`` or ``float32``; with ``float32`` TF32 is off
for matmuls and cuDNN), ``BENCH_ITERS`` (30) and ``BENCH_REPEATS`` (5).

The work is ``model(x)`` on ``np.random.RandomState(0).rand(B, 300, 300, 3)
* 255`` (f32, on the card) under ``torch.inference_mode``, the decode and
the greedy-NMS kernel included. Weights are ``examples.common.seeded_ssd300``'s
(seed 0, scaled into a trained detector's range, so the decode does a
served batch's work). Each of ``BENCH_REPEATS`` rounds is ``BENCH_ITERS``
calls back to back between two CUDA events, after three warm-up calls; the
round's img/s goes into ``runs`` (sorted) and ``value`` is the best round,
as in the JAX script. The JAX script's chained-checksum loop works around a
remote TPU whose ``block_until_ready`` does not block; CUDA events need no
such loop, so it is not ported.

An eager call is host-bound on the card whenever the host's launches
outlast the device work (always at batch 1, at batch 8 on a slow host), so
the line also times the same model through a CUDA graph of the call (``SSDPredictor``'s per-shape graph, the batch already on the card):
``graph_value`` and ``graph_runs`` the same rounds of replays,
``device_ms`` the card's own time a replay (``utils.profiling.time_calls``:
the card held while the host enqueues), and ``graph_bit_equal`` whether a
replay's detections equal the eager call's bit for bit. On the CPU
(``--device cpu``) the host clock times the eager rounds and the graph keys
are null. ``nms_launches`` is how often the NMS kernel ran in all of it.

Usage: python -m ssd_keras_torch.bench [--device cuda|cpu]
Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "runs",
"spread_pct", ...}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch

from ssd_keras_torch.examples.common import DTYPES, add_device_args, card_line, seeded_ssd300
from ssd_keras_torch.devices import target_device
from ssd_keras_torch.predictor import SSDPredictor
from ssd_keras_torch.utils.profiling import benchmark_fps, counters, time_calls

__all__ = ["BASELINE_FPS", "main"]

BASELINE_FPS = {8: 49.0, 1: 39.0}  # reference SSD300 on a GTX 1070
WARMUP = 3


@contextlib.contextmanager
def tf32_for(dtype: torch.dtype):
    """TF32 off for matmuls and cuDNN while ``dtype`` is f32 (f32 means f32);
    the settings as they were otherwise. Restored on exit."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield {"matmul": torch.backends.cuda.matmul.allow_tf32,
               "cudnn": torch.backends.cudnn.allow_tf32}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def rounds_img_per_s(forward, x, batch: int, n_iters: int, n_repeats: int):
    """Each round's img/s of ``n_iters`` calls of ``forward(x)``, sorted."""
    r = benchmark_fps(forward, x, n_iters=n_iters, n_repeats=n_repeats, warmup=WARMUP)
    return sorted(batch * n_iters / t for t in r["times_s"])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_args(p, compute_dtype=None)
    args = p.parse_args(argv)
    device = target_device(args.device)

    batch = int(os.environ.get("BENCH_BATCH", "8"))
    dtype_name = os.environ.get("BENCH_DTYPE", "bfloat16")
    dtype = DTYPES[dtype_name]
    n_iters = int(os.environ.get("BENCH_ITERS", "30"))
    n_repeats = int(os.environ.get("BENCH_REPEATS", "5"))
    card = card_line(device)

    model = seeded_ssd300("inference", dtype, device)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch, 300, 300, 3).astype(np.float32) * 255).to(device)

    launches_before = counters().get("nms.launches", 0)
    graph_runs = device_ms = graph_bit_equal = None
    with tf32_for(dtype) as tf32, torch.inference_mode():
        runs = rounds_img_per_s(model, x, batch, n_iters, n_repeats)
        if device.type == "cuda":
            replay = SSDPredictor(model, batch_size=batch)._fused_run(300, 300, np.float32)
            graph_bit_equal = bool(torch.equal(replay(x), model(x)))
            graph_runs = rounds_img_per_s(replay, x, batch, n_iters, n_repeats)
            device_ms = time_calls(lambda: replay(x), device, iters=n_iters, repeats=n_repeats)
            torch.cuda.synchronize(device)
    nms_launches = counters().get("nms.launches", 0) - launches_before
    if device.type == "cuda" and nms_launches <= 0:
        raise AssertionError("the benchmark never launched the NMS kernel on the card")

    # value = best of the rounds (the card's capability, least host noise);
    # the sorted rounds make the spread readable.
    fps = runs[-1]
    baseline = BASELINE_FPS.get(batch)  # no like-for-like ratio otherwise
    record = {
        "metric": f"ssd300_inference_fps_batch{batch}",
        "value": round(fps, 2),
        "unit": "images/s",
        "vs_baseline": round(fps / baseline, 2) if baseline else None,
        "runs": [round(r, 2) for r in runs],
        "spread_pct": round(100 * (runs[-1] - runs[0]) / runs[-1], 2),
        "graph_value": round(graph_runs[-1], 2) if graph_runs else None,
        "graph_runs": [round(r, 2) for r in graph_runs] if graph_runs else None,
        "device_ms": device_ms,
        "graph_bit_equal": graph_bit_equal,
        "nms_launches": nms_launches,
        "card": card,
        "dtype": dtype_name,
        "tf32": tf32,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
