"""Per-stage inference breakdown: conv trunk / decode stages / NMS / top-k.

Port of the JAX package's ``examples/profile_breakdown.py``, with its
measurements, sizes and record keys:

* SSD300 at batch 8 and 32 (bf16): the 'training' forward (the trunk, no
  decode) and the 'inference' forward (trunk + decode), back to back as a
  server calls them (``benchmark_fps``); then the decode stage by stage,
  each stage the decoder's own function (``decoder.decode_offsets``,
  ``compact_candidates``, ``_per_class_topk``, ``_nms_lanes``,
  ``_global_topk``, the order ``_decode_caffe_batched`` calls them in),
  timed on the tensors the previous stage made from the trunk's real
  ``y_pred``. The two forwards' device times (``*_device_ms``) go beside
  them: on the card the host's launches of an eager batch-8 'inference'
  call outlast its device work. The stages composed must give
  ``decode_detections_fixed``'s detections bit for bit, or the script
  raises. On the card the NMS stage is the CUDA kernel (``nms_impl:
  "cuda"``); on the CPU its plain version (``"plain"``).
* SSD7 (300x480, 5 classes): the dispatch-inclusive time of eager calls
  (``benchmark_fps``: the host's kernel launches included) against the
  device time of the same forward (``time_device``: the card held while
  the host enqueues, so the launches are hidden). Their gap is what the
  host's launches add to each call on this card. ``trunk_ms`` (the
  'training' forward) and ``decode_ms`` (the rest) split the device time.

Device times come from ``utils.profiling.time_calls``: ``time_device`` over
``ITERS_FORWARD`` forwards or ``ITERS_STAGE`` stage calls a repeat, the
hold lengthened to eight times the host's enqueue of them. On the CPU
(``--device cpu``) the host clock times the same calls; the record says
which timer ran. SSD300's weights are ``common.seeded_ssd300``'s, in a
trained detector's range, so the decode stages do a served batch's work
(raw He init saturates the softmax: one valid class a box); SSD7's are
the port's seeded init (its input is scaled to [-1, 1] in the graph), as
the JAX script's come from ``model.init``.

Usage: python -m ssd_keras_torch.examples.profile_breakdown [--out FILE]
Writes the record (markdown) to ``--out``; prints ``RESULT {json}``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from ssd_keras_torch import SSDConfig
from ssd_keras_torch import decoder as D
from ssd_keras_torch.examples.common import add_device_args, card_line, device_of, seeded_ssd300
from ssd_keras_torch.kernels import nms as nms_kernel
from ssd_keras_torch.models import ssd_7
from ssd_keras_torch.ops.boxes import border_delta
from ssd_keras_torch.utils.profiling import benchmark_fps, time_calls

# Calls a repeat: an eager SSD300 or SSD7 forward enqueues ~100-200 kernels,
# a decode stage a few; either way well under the launch queue's ~1000.
ITERS_FORWARD = 3
ITERS_STAGE = 20
REPEATS = 5
# decode_detections_fixed's defaults, which 'inference' mode uses.
CONFIDENCE_THRESH, IOU_THRESHOLD, TOP_K, NMS_MAX_OUTPUT = 0.01, 0.45, 200, 400
STAGE_KEYS = ("stage_offsets_softmax_ms", "stage_compaction_ms", "stage_per_class_topk_ms",
              "stage_nms_ms", "stage_global_topk_ms")


def decode_stages(y_pred, img_height=300, img_width=300, compact_pool="auto",
                  nms_max_output_size=NMS_MAX_OUTPUT, top_k=TOP_K):
    """``decode_detections_fixed`` of ``y_pred`` with these arguments (its
    defaults for the rest), stage by stage: returns ``([(record key, a call
    of the stage on its inputs)], detections)``, each stage's inputs the
    outputs of the one before."""
    n = y_pred.shape[1]
    m = D._resolve_compact_pool(compact_pool, n, nms_max_output_size)
    calls = []

    def stage(key, fn, *args):
        calls.append((key, lambda: fn(*args)))
        return fn(*args)

    corners = stage("stage_offsets_softmax_ms", D.decode_offsets, y_pred, "centroids", True,
                    img_height, img_width)
    scores, corners = stage("stage_compaction_ms", D.compact_candidates, y_pred[..., :-12],
                            corners, m)
    cand_scores, cand_boxes, valid = stage(
        "stage_per_class_topk_ms", D._per_class_topk, scores, corners,
        min(nms_max_output_size, n, m or n), D._f32(CONFIDENCE_THRESH))
    keep = stage("stage_nms_ms", D._nms_lanes, cand_boxes, valid, IOU_THRESHOLD,
                 border_delta("half"), nms_max_output_size)
    out = stage("stage_global_topk_ms", D._global_topk, keep, cand_scores, cand_boxes, top_k)
    return calls, out


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same shape and the same f32 bits (NaN and -0.0 included)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def _seeded_ssd7(cfg, mode, device):
    model, _ = ssd_7(cfg, mode=mode, compute_dtype=torch.bfloat16, device=device,
                     generator=torch.Generator().manual_seed(0))
    return model


def ssd300_breakdown(batch, device, fps_iters=20, iters_forward=ITERS_FORWARD,
                     iters_stage=ITERS_STAGE, repeats=REPEATS):
    cfg = SSDConfig.ssd300(n_classes=20)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch, 300, 300, 3).astype(np.float32) * 255).to(device)
    model_t = seeded_ssd300("training", torch.bfloat16, device, cfg)
    model_i = seeded_ssd300("inference", torch.bfloat16, device, cfg)

    launches0 = nms_kernel.launches
    with torch.no_grad():
        r_trunk = benchmark_fps(model_t, x, n_iters=fps_iters, n_repeats=min(repeats, 3))
        r_e2e = benchmark_fps(model_i, x, n_iters=fps_iters, n_repeats=min(repeats, 3))
        trunk_dev = time_calls(lambda: model_t(x), device, iters_forward, repeats)["median"]
        e2e_dev = time_calls(lambda: model_i(x), device, iters_forward, repeats)["median"]

        # The decode's inputs: the real y_pred from the trunk.
        y = model_t(x)
        calls, composed = decode_stages(y)
        if not bit_equal(composed, D.decode_detections_fixed(y, img_height=300,
                                                             img_width=300)):
            raise AssertionError("the decoder's stages composed differ from "
                                 "decode_detections_fixed")
        stages = {key: time_calls(call, device, iters_stage, repeats) for key, call in calls}
    row = {
        "batch": batch,
        "trunk_ms": r_trunk["ms_per_batch"],
        "e2e_ms": r_e2e["ms_per_batch"],
        "e2e_img_per_s": r_e2e["fps"],
        "decode_in_e2e_ms": r_e2e["ms_per_batch"] - r_trunk["ms_per_batch"],
        "trunk_device_ms": trunk_dev,
        "e2e_device_ms": e2e_dev,
        "decode_in_e2e_device_ms": e2e_dev - trunk_dev,
        "decode_stage_sum_ms": sum(s["median"] for s in stages.values()),
        **{key: stages[key]["median"] for key in STAGE_KEYS},
        "nms_impl": "cuda" if torch.device(device).type == "cuda" else "plain",
        "nms_lanes": [batch * 20, min(NMS_MAX_OUTPUT, D._resolve_compact_pool(
            "auto", y.shape[1], NMS_MAX_OUTPUT))],
        "stages_equal_decoder": True,
        "nms_launches": nms_kernel.launches - launches0,
        "stage_spread_pct": {key: s["spread_pct"] for key, s in stages.items()},
        "stage_timer": {"timer": stages["stage_nms_ms"]["timer"], "iters": iters_stage,
                        "repeats": repeats},
    }
    print(row, flush=True)
    return row


def ssd7_dispatch_vs_compute(batch, device, fps_iters=30, iters=ITERS_FORWARD,
                             repeats=REPEATS):
    cfg = SSDConfig.ssd7(n_classes=5, img_height=300, img_width=480)
    model = _seeded_ssd7(cfg, "inference", device)
    # Training mode shares the whole conv stack and heads with inference;
    # the difference is the decode over SSD7's 12160 anchors.
    model_t = _seeded_ssd7(cfg, "training", device)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch, 300, 480, 3).astype(np.float32) * 255).to(device)

    with torch.no_grad():
        r_dispatch = benchmark_fps(model, x, n_iters=fps_iters, n_repeats=min(repeats, 3))
        on_device = time_calls(lambda: model(x), device, iters, repeats)
        trunk = time_calls(lambda: model_t(x), device, iters, repeats)
    ms_on_device = on_device["median"]
    row = {
        "batch": batch,
        "dispatch_inclusive_ms": r_dispatch["ms_per_batch"],
        "dispatch_inclusive_img_per_s": r_dispatch["fps"],
        "on_device_chained_ms": ms_on_device,
        "on_device_chained_img_per_s": batch / ms_on_device * 1000,
        "dispatch_overhead_ms": r_dispatch["ms_per_batch"] - ms_on_device,
        "trunk_ms": trunk["median"],
        "decode_ms": ms_on_device - trunk["median"],
        "on_device_spread_pct": on_device["spread_pct"],
        "timer": {"timer": on_device["timer"], "iters": iters, "repeats": repeats},
    }
    print(row, flush=True)
    return row


def write_record(path, record) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# Per-stage inference profile ({record['card']}, bf16)\n\n")
        f.write(
            "Trunk = 'training' forward (no decode); e2e = 'inference' forward "
            "(trunk + decode); both dispatch-inclusive (`benchmark_fps`, CUDA "
            "events around back-to-back eager calls). Decode stages are the "
            "decoder's own functions in the order it calls them, each timed "
            "on the previous stage's outputs from the trunk's real y_pred, "
            "by device time (`time_device`: the card held while the host "
            "enqueues, so the host's launches are hidden). `decode_in_e2e_ms` "
            "(e2e - trunk) includes the host's launches of the decode's "
            "kernels; the stage sum does not. On the card the NMS stage is "
            "the CUDA kernel (`nms_impl`).\n\n")
        f.write("## SSD300\n\n```json\n" + json.dumps(record["ssd300"], indent=2)
                + "\n```\n\n")
        f.write(
            "## SSD7 dispatch vs compute\n\n"
            "Dispatch-inclusive = eager calls back to back, the host's "
            "kernel launches included (`benchmark_fps`); on-device = the "
            "device time of the same forward (`time_device`). "
            "`dispatch_overhead_ms` = their difference: what the host's "
            "kernel launches add to each call on this card when they are "
            "slower than the kernels they launch. `trunk_ms` ('training' "
            "forward) and `decode_ms` (the rest of the on-device time) "
            "split the device time.\n\n")
        f.write("```json\n" + json.dumps(record["ssd7"], indent=2) + "\n```\n")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="per-stage inference profile")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "profile.md"))
    add_device_args(p, compute_dtype=None)
    args = p.parse_args(argv)
    device = device_of(args)

    ssd300 = [ssd300_breakdown(8, device), ssd300_breakdown(32, device)]
    ssd7 = [ssd7_dispatch_vs_compute(1, device), ssd7_dispatch_vs_compute(8, device)]

    record = {"card": card_line(device), "ssd300": ssd300, "ssd7": ssd7}
    write_record(args.out, record)
    print("RESULT " + json.dumps(record))
    return record


if __name__ == "__main__":
    main()
