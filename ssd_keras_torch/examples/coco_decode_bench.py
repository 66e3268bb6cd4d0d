"""Cross-class candidate compaction on COCO-scale (81-class) decode.

Port of the JAX package's ``examples/coco_decode_bench.py``. The per-class
top-k over all 8732 boxes is the decode's largest stage at 81 classes;
compaction (``decoder.compact_candidates``) selects the top M boxes by
max-over-classes score once, then runs the per-class top-k over M << N.
This script sweeps ``compact_pool`` over ``COMPACT_POOLS`` for SSD300
COCO-81 and VOC-21, bf16 at batch 8: each point the 'training' forward
plus ``decode_detections_fixed``, timed back to back with
``benchmark_fps(n_iters=25, n_repeats=3)`` (the host's launches
included, as a server runs it). Each row keeps the JAX script's keys and
adds the same call's device time (``device_ms``, ``time_calls``: on the
card the host's launches hidden; they set the pace of an eager batch-8
call there, so only the device time shows what compaction saves) and the
NMS kernel's launches in that point's run (none on the CPU, where the
plain version runs).

The weights are the port's seeded random init, as the JAX script's come
from ``model.init``: the untrained scores that make nearly every box
valid, the decode's heaviest case.

Usage: python -m ssd_keras_torch.examples.coco_decode_bench [--out FILE]
Writes the record (markdown) to ``--out``; prints the rows as JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

import numpy as np
import torch

from ssd_keras_torch import SSDConfig
from ssd_keras_torch.decoder import decode_detections_fixed
from ssd_keras_torch.examples.common import add_device_args, card_line, device_of
from ssd_keras_torch.models import ssd_300
from ssd_keras_torch.utils.profiling import benchmark_fps, counters, time_calls

COMPACT_POOLS = (0, 512, 1024, 2048, "auto")
# Calls a repeat of the device-time reading (~150 kernels a call).
ITERS = 3


def sweep(device, batch=8, n_iters=25, n_repeats=3, iters=ITERS, warmup=2):
    """One row a (model, compact_pool) point, each timing after ``warmup``
    calls. A non-finite time raises."""
    rows = []
    for n_classes, tag in ((80, "coco81"), (20, "voc21")):
        cfg = SSDConfig.ssd300(n_classes=n_classes,
                               dataset="coco" if n_classes == 80 else "voc")
        model, _ = ssd_300(cfg, mode="training", compute_dtype=torch.bfloat16, device=device,
                           generator=torch.Generator().manual_seed(0))
        x = torch.from_numpy(
            np.random.RandomState(0).rand(batch, 300, 300, 3).astype(np.float32) * 255
        ).to(device)

        for m in COMPACT_POOLS:
            def e2e(b, m=m):
                return decode_detections_fixed(model(b), img_height=300, img_width=300,
                                               compact_pool=m)

            launches0 = counters().get("nms.launches", 0)
            r = benchmark_fps(e2e, x, n_iters=n_iters, n_repeats=n_repeats, warmup=warmup)
            with torch.no_grad():
                dev = time_calls(lambda: e2e(x), device, iters, n_repeats, warmup)
            rows.append({"model": tag, "compact_pool": m,
                         "ms_per_batch": r["ms_per_batch"],
                         "img_per_s": r["fps"],
                         "device_ms": dev["median"],
                         "device_spread_pct": dev["spread_pct"],
                         "nms_launches": counters().get("nms.launches", 0) - launches0})
            if not all(math.isfinite(rows[-1][k])
                       for k in ("ms_per_batch", "img_per_s", "device_ms")):
                raise AssertionError(f"non-finite timing: {rows[-1]}")
            print(rows[-1], flush=True)
    return rows


def write_record(path, card, batch, rows) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# COCO-scale decode: cross-class candidate compaction\n\n")
        f.write(f"Card: {card}. SSD300 batch {batch}, bf16: 'training' forward + "
                "`decode_detections_fixed`, back-to-back eager calls, best of 3 "
                "repeats of 25 (`benchmark_fps`).\n\n")
        f.write("| compact_pool | COCO-81 img/s | VOC-21 img/s | COCO-81 device ms | "
                "VOC-21 device ms |\n|---|---|---|---|---|\n")
        by = {(r["model"], r["compact_pool"]): r for r in rows}
        for m in COMPACT_POOLS:
            coco, voc = by[("coco81", m)], by[("voc21", m)]
            f.write(f"| {m or 'off'} | {coco['img_per_s']:.1f} | {voc['img_per_s']:.1f} | "
                    f"{coco['device_ms']:.4f} | {voc['device_ms']:.4f} |\n")
        f.write("\n```json\n" + json.dumps(rows, indent=1) + "\n```\n")


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="compact_pool sweep at COCO and VOC scale")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "coco_decode.md"))
    add_device_args(p, compute_dtype=None)
    args = p.parse_args(argv)
    device = device_of(args)

    rows = sweep(device)
    write_record(args.out, card_line(device), 8, rows)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
