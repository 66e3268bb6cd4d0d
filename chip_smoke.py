#!/usr/bin/env python3
"""Drive the PyTorch port's SSD300 serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; the first failure raises and the script exits non-zero:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build the CUDA kernels from ``ssd_keras_torch/csrc`` with nvcc (sm_90a).
3. Kernel against plain: the greedy-NMS kernel must equal its plain PyTorch
   version bit for bit at the main path's shapes (L = 160, 640 and 8 lanes
   of K = 400), with border_delta 0 and +-1, non-prefix valid masks and
   empty lanes.
4. Main path: SSD300 VOC at full width, batch 8, 'inference' mode on the
   card, from seeded weights: at f32 (TF32 off) against the same port on
   the CPU, at bf16 (finite, in-frame output), then 'inference_fast', then
   bf16 at batch 1. The
   NMS launch count is reset before and read after; it must have moved. The
   path must not make the host wait for the device.
5. Serving: ``SSDPredictor`` answers 8 frames of 300x300, 5 of 480x640 and
   1 frame, all uint8.
6. Timings (CUDA events after warm-up): SSD300 batch-8 'inference' img/s at
   bf16 and f32; the NMS kernel against the plain version at L=160, K=400.

It prints JSON lines (timings, then the kernels line), then as its last line
``{"ok": true, "device": {...}}``. With no CUDA device it raises before
printing any result. Imports torch, numpy and ssd_keras_torch only.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ssd_keras_torch import SSDConfig, SSDPredictor, ssd_300
from ssd_keras_torch.decoder import decode_detections_fixed
from ssd_keras_torch.kernels import build
from ssd_keras_torch.kernels import nms as nms_kernel
from ssd_keras_torch.ops.nms import greedy_nms_mask

SEED = 0
BATCH = 8
IOU_THRESHOLD = 0.45

# f32 card-vs-CPU tolerances. The two devices sum the convolutions in other
# orders (cuDNN's algorithms against oneDNN's); through 23 layers and the
# softmax that moves y_pred by ~1e-5, a decoded score by about as much and a
# box coordinate (in pixels) by ~100 times that. A flipped NMS or threshold
# decision removes a whole row, which the row matching reports.
Y_PRED_TOL = 1e-3
SCORE_TOL = 1e-4
BOX_TOL = 1e-2


def log(msg):
    print(msg, flush=True)


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0]


def model_for(state, mode, dtype, device):
    """SSD300 VOC in ``mode`` holding ``state`` (f32 CPU), cast and moved."""
    model, _ = ssd_300(SSDConfig.ssd300(), mode=mode, compute_dtype=dtype, device=device)
    model.load_state_dict(state)
    return model


def seeded_state():
    """Weights from a seeded generator, scaled into a trained detector's
    output range. He init carries the raw 0-255 input's magnitude (~75 RMS)
    through the trunk, which saturates the softmax at exactly 1.0 and
    overflows the box exponent: conv1_1 at 1/100 brings the logits to O(1).
    The loc heads at 1/4 then give encoded offsets of ~0.4 RMS, so every
    decoded box stays near its anchor, as a trained model's do."""
    model, _ = ssd_300(SSDConfig.ssd300(), generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.conv1_1.weight.mul_(0.01)
        for name, module in model.named_children():
            if name.endswith("_mbox_loc"):
                module.weight.mul_(0.25)
    return model.state_dict()


def random_lanes(rng, lanes, k, prefix=True):
    """(L, K, 4) overlapping corner boxes in a 300x300 frame, (L, K) valid."""
    centre = rng.rand(lanes, k, 2) * 300
    half = (10 + rng.rand(lanes, k, 2) * 90) / 2
    boxes = np.concatenate([centre - half, centre + half], axis=-1).astype(np.float32)
    if prefix:
        valid = np.arange(k)[None, :] < rng.randint(k // 2, k + 1, size=(lanes, 1))
    else:
        valid = rng.rand(lanes, k) > 0.4
        valid[::7] = False  # empty lanes
    return boxes, valid


def match_rows(got, expected, score_tol, box_tol):
    """Match one image's non-zero detection rows one to one by class, score
    and box. Returns (unmatched expected rows, unmatched got rows)."""
    got = got[got[:, 1] > 0]
    expected = expected[expected[:, 1] > 0]
    free = list(range(len(got)))
    missing = []
    for row in expected:
        for j in free:
            if (got[j, 0] == row[0] and abs(got[j, 1] - row[1]) <= score_tol
                    and np.all(np.abs(got[j, 2:] - row[2:]) <= box_tol)):
                free.remove(j)
                break
        else:
            missing.append(row)
    return missing, [got[j] for j in free]


def compare_detections(name, got, expected, score_tol, box_tol):
    """Every row must match, except rows at the top-k cut (a score within
    ``score_tol`` of the last one kept), which are reported as cut flips."""
    flips = 0
    for b in range(expected.shape[0]):
        missing, extra = match_rows(got[b], expected[b], score_tol, box_tol)
        cut = expected[b][expected[b, :, 1] > 0][-1, 1]
        for row in missing + extra:
            if abs(row[1] - cut) > score_tol:
                raise AssertionError(
                    f"{name}: image {b} row {row.tolist()} has no counterpart: a "
                    "confidence or IoU threshold flip, or a wrong value")
            flips += 1
    nz = expected[..., 1] > 0
    score_err = float(np.abs(got[..., 1] - expected[..., 1])[nz].max())
    log(f"{name}: {int(nz.sum())} detections matched, {flips} top-k cut flips, "
        f"max |score diff| (same rank) {score_err:.3g}")


def check_in_frame(name, dets, height, width, n_classes):
    """Finite, a foreground class, a score in (0, 1], a positive extent, and
    the box overlapping the image (SSD decoding does not clip, so a box may
    cross the border)."""
    if not np.isfinite(dets).all():
        raise AssertionError(f"{name}: non-finite detections")
    cls, score, x1, y1, x2, y2 = dets.T
    ok = ((cls >= 1) & (cls <= n_classes) & (score > 0) & (score <= 1)
          & (x2 > x1) & (y2 > y1) & (x2 > 0) & (y2 > 0) & (x1 < width) & (y1 < height))
    if not ok.all():
        raise AssertionError(f"{name}: rows out of frame: {dets[~ok][:3].tolist()}")


def time_cuda(fn, iters, repeats=5, warmup=3):
    """Milliseconds per call of ``fn``, one value per repeat (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return runs


def summary(runs):
    med = statistics.median(runs)
    return dict(median=med, min=min(runs), max=max(runs),
                spread_pct=100 * (max(runs) - min(runs)) / med, runs=runs)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; the port's main path runs on one")
    device = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)

    # 1. Device.
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")

    # 2. Build.
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    log(f"built {build.BUILD_DIR.name}/ with nvcc in {build_s:.2f} s")

    # 3. Kernel against plain, on the card.
    rng = np.random.RandomState(SEED)
    max_err = 0.0
    cases = [(160, True, 0.0), (640, True, 0.0), (8, True, 0.0),
             (160, False, 1.0), (640, False, -1.0), (8, False, 1.0)]
    for lanes, prefix, d in cases:
        boxes, valid = random_lanes(rng, lanes, 400, prefix)
        b, v = torch.from_numpy(boxes).to(device), torch.from_numpy(valid).to(device)
        got = nms_kernel.greedy_nms_mask_batched(b, v, IOU_THRESHOLD, d)
        plain = greedy_nms_mask(b, v, IOU_THRESHOLD, d)
        torch.cuda.synchronize()
        err = float((got != plain).float().max())
        max_err = max(max_err, err)
        if not torch.equal(got, plain):
            raise AssertionError(
                f"NMS kernel != plain at L={lanes} prefix={prefix} d={d}: "
                f"{int((got != plain).sum())} of {got.numel()} flags differ")
        cpu = greedy_nms_mask(torch.from_numpy(boxes), torch.from_numpy(valid), IOU_THRESHOLD, d)
        if not torch.equal(got.cpu(), cpu):
            raise AssertionError(f"NMS kernel != plain on the CPU at L={lanes} d={d}")
        log(f"nms kernel == plain (card and CPU), L={lanes} K=400 prefix={prefix} "
            f"border_delta={d:+.0f}: {int(got.sum())} kept of {int(v.sum())} valid")

    # 4. Main path.
    state = seeded_state()
    x_host = np.random.RandomState(SEED + 1).randint(0, 256, (BATCH, 300, 300, 3)).astype(np.float32)
    x = torch.from_numpy(x_host).to(device)
    f32 = model_for(state, "inference", torch.float32, device)
    bf16 = model_for(state, "inference", torch.bfloat16, device)
    fast = model_for(state, "inference_fast", torch.float32, device)

    nms_kernel.launches = 0
    det_f32 = f32(x)
    torch.cuda.synchronize()
    after_f32 = nms_kernel.launches
    det_bf16 = bf16(x)
    torch.cuda.synchronize()
    after_bf16 = nms_kernel.launches
    det_fast = fast(x)
    torch.cuda.synchronize()
    after_fast = nms_kernel.launches
    det_one = bf16(x[:1])  # batch 1: the per-class gathers come back strided
    torch.cuda.synchronize()
    main_launches = nms_kernel.launches
    log(f"main path NMS launches: f32 {after_f32}, bf16 {after_bf16 - after_f32}, "
        f"fast {after_fast - after_bf16}, bf16 batch 1 {main_launches - after_fast}")
    if not (0 < after_f32 < after_bf16 < after_fast < main_launches):
        raise AssertionError("the main path did not launch the NMS kernel in every run")

    for name, det in (("f32", det_f32), ("bf16", det_bf16), ("fast", det_fast),
                      ("bf16 batch 1", det_one)):
        det = det.cpu().numpy()
        if det.shape != (len(det), 200, 6) or len(det) not in (1, BATCH):
            raise AssertionError(f"{name}: shape {det.shape}")
        rows = det[det[..., 1] > 0]
        if len(rows) < BATCH:
            raise AssertionError(f"{name}: only {len(rows)} detections")
        check_in_frame(name, rows, 300, 300, 20)

    # Once its constants are on the card, the main path never makes the host
    # wait for the device (a blocking copy or a read of a device value).
    torch.cuda.set_sync_debug_mode("error")
    try:
        bf16(x), f32(x), fast(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("main path: no host synchronisation (torch.cuda sync debug mode 'error')")

    # f32 on the card against the same port on the CPU (plain NMS).
    cpu_det = model_for(state, "inference", torch.float32, "cpu")(torch.from_numpy(x_host))
    cpu_fast = model_for(state, "inference_fast", torch.float32, "cpu")(torch.from_numpy(x_host))
    train_cuda = model_for(state, "training", torch.float32, device)(x)
    train_cpu = model_for(state, "training", torch.float32, "cpu")(torch.from_numpy(x_host))
    y_err = float((train_cuda.cpu() - train_cpu).abs().max())
    log(f"y_pred card f32 vs CPU: max |diff| {y_err:.3g} (limit {Y_PRED_TOL})")
    if y_err > Y_PRED_TOL:
        raise AssertionError("y_pred on the card differs from the CPU")
    # The decode alone on one y_pred: the kernel path against the plain one.
    same_cuda = decode_detections_fixed(train_cuda, img_height=300, img_width=300)
    same_cpu = decode_detections_fixed(train_cuda.cpu(), img_height=300, img_width=300)
    compare_detections(
        "decode of one y_pred, card vs CPU", same_cuda.cpu().numpy(), same_cpu.numpy(), 0.0, 1e-3)
    compare_detections("inference f32, card vs CPU", det_f32.cpu().numpy(),
                       cpu_det.numpy(), SCORE_TOL, BOX_TOL)
    compare_detections("inference_fast f32, card vs CPU", det_fast.cpu().numpy(),
                       cpu_fast.numpy(), SCORE_TOL, BOX_TOL)

    # 5. Serving.
    predictor = SSDPredictor(bf16, batch_size=BATCH)
    srng = np.random.RandomState(SEED + 2)
    requests = [
        ("8 x 300x300", [srng.randint(0, 256, (300, 300, 3), dtype=np.uint8) for _ in range(8)]),
        ("5 x 480x640", [srng.randint(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(5)]),
        ("1 x 300x300", [srng.randint(0, 256, (300, 300, 3), dtype=np.uint8)]),
    ]
    nms_kernel.launches = 0
    for name, images in requests:
        t0 = time.perf_counter()
        out = predictor.predict(images)
        ms = 1e3 * (time.perf_counter() - t0)
        if len(out) != len(images):
            raise AssertionError(f"request {name}: {len(out)} answers")
        for img, dets in zip(images, out):
            if dets.ndim != 2 or dets.shape[1] != 6 or len(dets) == 0:
                raise AssertionError(f"request {name}: detections of shape {dets.shape}")
            check_in_frame(f"request {name}", dets, img.shape[0], img.shape[1], 20)
        log(f"request {name}: answered in {ms:.1f} ms (host clock, first call), "
            f"{sum(len(d) for d in out)} detections")
    serve_launches = nms_kernel.launches
    if serve_launches < len(requests):
        raise AssertionError(f"serving launched the NMS kernel {serve_launches} times")

    # 6. Timings.
    lines = []
    for dtype_name, model in (("bf16", bf16), ("f32", f32)):
        ms = summary(time_cuda(lambda: model(x), iters=20))
        lines.append(dict(
            metric="ssd300_inference_img_per_s", batch=BATCH, dtype=dtype_name,
            img_per_s=BATCH * 1e3 / ms["median"],
            img_per_s_runs=[BATCH * 1e3 / r for r in ms["runs"]],
            ms_per_batch=ms, card=card,
        ))
    boxes, _ = random_lanes(np.random.RandomState(SEED + 3), 160, 400)
    b = torch.from_numpy(boxes).to(device)
    v = torch.ones(160, 400, dtype=torch.bool, device=device)  # worst case: all valid
    kernel_ms = summary(time_cuda(lambda: nms_kernel.greedy_nms_mask_batched(b, v, IOU_THRESHOLD), 50))
    plain_ms = summary(time_cuda(lambda: greedy_nms_mask(b, v, IOU_THRESHOLD), 3, warmup=1))
    lines.append(dict(metric="nms_ms", lanes=160, k=400, valid="all", kernel_ms=kernel_ms,
                      plain_ms=plain_ms, card=card))
    for line in lines:
        print(json.dumps(line), flush=True)

    kernels = [dict(
        name="greedy_nms", route="cuda", source="ssd_keras_torch/csrc/nms.cu",
        replaces="ssd_keras_tpu/kernels/nms_pallas.py:52", launches=main_launches,
        max_abs_err=max_err, ms=kernel_ms["median"], plain_ms=plain_ms["median"],
    )]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
