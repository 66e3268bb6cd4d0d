"""Serving-trunk experiment: preprocessing fold, per-block roofline, and
the card's convolution setting.

Port of the JAX package's ``examples/serving_trunk_bench.py``, with its
measurements, sizes and record keys (SSD300 batch 8, bf16):

1. **Preprocessing cost**: the 'training' forward (trunk + heads) with the
   in-graph mean subtraction and BGR swap, without them, and with the swap
   folded into conv1_1's kernel by ``optimize.fold_preprocessing``. The
   fold's exactness is read twice: on the bf16 graph as the JAX script
   reads it (``fold_max_abs_diff``; bf16 is not bit-exact under a changed
   summation order, so it is set beside the bf16 graph's own rounding,
   ``bf16_rounding_max_abs_diff``, its largest |diff| from the f32 graph),
   and on the f32 graph (TF32 off) at ``tests/test_torch_optimize.py::
   test_fold_preprocessing_exact``'s tolerance (``FOLD_RTOL``,
   ``FOLD_ATOL``).
2. **Per-block roofline**: the six VGG stages of the JAX script, each the
   port's own SSD300 layers and weights (``SSD300._convs`` and the SAME 2x2
   ``max_pool2d(ceil_mode=True)``; conv5 with pool5, its 3x3 stride-1 pool,
   as serving runs it) timed on its real input from the stage before, by
   device time. The FLOP and byte arithmetic is the JAX script's; the
   floors are read against one H100 SXM's data-sheet peaks
   (``PEAK_BF16_TFLOPS``, ``HBM_GBPS``). A share over 100% or a floor over
   the measured time is an impossible reading and raises.
3. **Convolution setting sweep** (``--flags``): SSD300 batch-8 bf16
   'inference', dispatched and device-time img/s, under each of
   ``FLAG_SETS`` (``torch.backends.cudnn.benchmark``, which must be set
   before a process's first convolution), each in a fresh process, with
   the largest |diff| of its detections from ``default``'s.

Weights: ``common.seeded_ssd300``, scores and offsets in a trained
detector's range (raw He init on 0-255 input saturates the softmax, so
detections and the fold's f32 check would read saturated values). The
times do not depend on the weights' values.

Usage: python -m ssd_keras_torch.examples.serving_trunk_bench [--flags]
Writes the record (markdown) to ``--out``; prints ``RESULT {json}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ssd_keras_torch import SSDConfig
from ssd_keras_torch.examples.common import add_device_args, card_line, device_of, seeded_ssd300
from ssd_keras_torch.models.layers import preprocess_input
from ssd_keras_torch.optimize import fold_preprocessing
from ssd_keras_torch.utils.profiling import benchmark_fps, counters, time_calls

# NVIDIA's data sheet for one H100 SXM: dense bf16 on the tensor cores, HBM3.
PEAK_BF16_TFLOPS = 989.0
HBM_GBPS = 3350.0
# test_fold_preprocessing_exact's tolerance (np.testing.assert_allclose).
FOLD_RTOL = FOLD_ATOL = 1e-5
# A forward enqueues ~150 kernels, a block ~10.
ITERS_FORWARD, ITERS_BLOCK, REPEATS = 3, 10, 5

# SSD300 trunk stages: (name, n_convs, channels, input hw, input cin, 2x2-pooled?)
STAGES = [
    ("conv1_x+pool", 2, 64, 300, 3, True),
    ("conv2_x+pool", 2, 128, 150, 64, True),
    ("conv3_x+pool", 3, 256, 75, 128, True),
    ("conv4_x+pool", 3, 512, 38, 256, True),
    ("conv5_x+pool(s1)", 3, 512, 19, 512, False),
    ("fc6(dil6)+fc7", 2, 1024, 19, 512, False),
]
CONVS = {
    "conv1_x+pool": ("conv1_1", "conv1_2"),
    "conv2_x+pool": ("conv2_1", "conv2_2"),
    "conv3_x+pool": ("conv3_1", "conv3_2", "conv3_3"),
    "conv4_x+pool": ("conv4_1", "conv4_2", "conv4_3"),
    "conv5_x+pool(s1)": ("conv5_1", "conv5_2", "conv5_3"),
    "fc6(dil6)+fc7": ("fc6", "fc7"),
}
FLAG_SETS = {"default": False, "cudnn_benchmark": True}
ROOT = Path(__file__).resolve().parents[2]


def _input(batch, device):
    x = np.random.RandomState(0).rand(batch, 300, 300, 3).astype(np.float32) * 255
    return torch.from_numpy(x).to(device)


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def measure_preprocessing(device, batch=8, iters=ITERS_FORWARD, repeats=REPEATS):
    x = _input(batch, device)
    cfg = SSDConfig.ssd300()
    cfg_off = dataclasses.replace(
        cfg, subtract_mean=None, divide_by_stddev=None, swap_channels=None)
    out = {}
    models = {}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            model = seeded_ssd300("training", dtype, device, cfg)
            state = model.state_dict()
            off = seeded_ssd300("training", dtype, device, cfg_off)
            state_fold, cfg_fold = fold_preprocessing(state, cfg)
            fold = seeded_ssd300("training", dtype, device, cfg_fold)
            fold.load_state_dict(state_fold)
            models[dtype] = model, off, fold
        model, off, fold = models[torch.bfloat16]
        for key, m in (("trunk_with_preprocessing_ms", model),
                       ("trunk_without_preprocessing_ms", off),
                       ("trunk_swap_folded_ms", fold)):
            out[key] = time_calls(lambda: m(x), device, iters, repeats)["median"]

        y0, y1 = model(x[:2]), fold(x[:2])
        out["fold_max_abs_diff"] = float((y0 - y1).abs().max())
        model32, _, fold32 = models[torch.float32]
        with _no_tf32():
            f0, f1 = model32(x[:2]), fold32(x[:2])
    out["bf16_rounding_max_abs_diff"] = float((y0 - f0).abs().max())
    out["fold_max_abs_diff_f32"] = float((f0 - f1).abs().max())
    out["fold_f32_within_test_tolerance"] = bool(
        ((f1 - f0).abs() <= FOLD_ATOL + FOLD_RTOL * f0.abs()).all())
    out["preprocessing_cost_ms"] = (out["trunk_with_preprocessing_ms"]
                                    - out["trunk_without_preprocessing_ms"])
    print(out, flush=True)
    return out


def block_row(name, n_convs, ch, hw, cin, batch, ms):
    """The JAX script's row for one block measured at ``ms``: its FLOPs and
    bytes, achieved TFLOP/s and the floors at the H100's peaks. Raises on an
    impossible reading (over 100% of peak, or under the floor)."""
    fc = name.startswith("fc6")
    flops = 0
    c_in = cin
    for i in range(n_convs):
        k = 1 if (fc and i > 0) else 3
        flops += 2 * batch * hw * hw * c_in * ch * k * k
        c_in = ch
    tflops = flops / (ms / 1e3) / 1e12
    # HBM-bound floor: activations in + out + weights once.
    act_bytes = batch * hw * hw * (cin + n_convs * ch) * 2
    w_bytes = sum(
        (1 if (fc and i > 0) else 9) * (cin if i == 0 else ch) * ch * 2
        for i in range(n_convs))
    hbm_floor_ms = (act_bytes + w_bytes) / (HBM_GBPS * 1e9) * 1e3
    mxu_floor_ms = flops / (PEAK_BF16_TFLOPS * 1e12) * 1e3
    row = {
        "stage": name, "ms": ms,
        "gflops": round(flops / 1e9, 1),
        "achieved_tflops": tflops,
        "pct_of_peak": 100 * tflops / PEAK_BF16_TFLOPS,
        "mxu_floor_ms": mxu_floor_ms,
        "hbm_floor_ms": hbm_floor_ms,
        "floor_ms": max(mxu_floor_ms, hbm_floor_ms),
    }
    if row["pct_of_peak"] > 100 or row["floor_ms"] > ms:
        raise AssertionError(f"impossible reading for {name}: {ms} ms is "
                             f"{row['pct_of_peak']:.1f}% of peak, floor {row['floor_ms']} ms")
    return row


def trunk_blocks(model):
    """The six stages as calls of ``model``'s own layers on NCHW input."""
    def block(name, pooled):
        def run(t):
            t = model._convs(t, CONVS[name])
            if pooled:
                return F.max_pool2d(t, 2, 2, ceil_mode=True)
            if name.startswith("conv5"):
                return F.max_pool2d(t, 3, 1, padding=1)  # pool5
            return t
        return run
    return [block(name, pooled) for name, _, _, _, _, pooled in STAGES]


def measure_blocks(device, batch=8, iters=ITERS_BLOCK, repeats=REPEATS):
    model = seeded_ssd300("training", torch.bfloat16, device)
    consts = model._constants(torch.device(device))
    rows = []
    with torch.no_grad():
        # Block 1's input is the forward's own: preprocessed, NHWC viewed as NCHW.
        t = preprocess_input(_input(batch, device).to(torch.bfloat16), consts["subtract_mean"],
                             consts["divide_by_stddev"], consts["swap_channels"]
                             ).permute(0, 3, 1, 2)
        for (name, n_convs, ch, hw, cin, _), run in zip(STAGES, trunk_blocks(model)):
            if tuple(t.shape[1:]) != (cin, hw, hw):
                raise AssertionError(f"{name} takes {tuple(t.shape)}")
            ms = time_calls(lambda t=t: run(t), device, iters, repeats)["median"]
            rows.append(block_row(name, n_convs, ch, hw, cin, batch, ms))
            print(rows[-1], flush=True)
            t = run(t)
    return rows


def flag_run(name, batch, device, n_iters=25, n_repeats=3, iters=ITERS_FORWARD,
             out=None):
    """One process's part of the sweep: set ``FLAG_SETS[name]`` before any
    convolution, time SSD300 'inference', print ``FLAGRESULT {json}`` (with
    the process's NMS kernel launches) and save the detections to ``out``
    (.npy)."""
    torch.backends.cudnn.benchmark = FLAG_SETS[name]
    model = seeded_ssd300("inference", torch.bfloat16, device)
    x = _input(batch, device)
    with torch.no_grad():
        r = benchmark_fps(model, x, n_iters=n_iters, n_repeats=n_repeats)
        ms = time_calls(lambda: model(x), device, iters, n_repeats)["median"]
        det = model(x).cpu().numpy()
    if out:
        np.save(out, det)
    print("FLAGRESULT " + json.dumps({
        "dispatched_img_per_s": r["fps"], "chained_ms": ms,
        "chained_img_per_s": batch / ms * 1000,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "nms_launches": counters().get("nms.launches", 0)}), flush=True)


def flag_sweep(device, batch=8, n_iters=25, n_repeats=3):
    """Each of ``FLAG_SETS`` in a fresh process (``cudnn.benchmark`` binds
    at a process's first convolution). A failed process raises."""
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in FLAG_SETS:
            npy = os.path.join(tmp, f"{name}.npy")
            prog = (f"from ssd_keras_torch.examples.serving_trunk_bench import flag_run\n"
                    f"flag_run({name!r}, {batch}, {str(device)!r}, {n_iters}, {n_repeats}, "
                    f"out={npy!r})\n")
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [
                p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
            t0 = time.time()
            p = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                               env=env, cwd=str(ROOT), timeout=900)
            line = [l for l in p.stdout.splitlines() if l.startswith("FLAGRESULT ")]
            if p.returncode != 0 or not line:
                raise RuntimeError(f"flag set {name} failed:\n{(p.stderr or p.stdout)[-2000:]}")
            results[name] = json.loads(line[0][len("FLAGRESULT "):])
            results[name]["wall_s"] = time.time() - t0
            det = np.load(npy)
            results[name]["max_abs_diff_vs_default"] = float(
                np.abs(det - np.load(os.path.join(tmp, "default.npy"))).max())
            print(name, results[name], flush=True)
    return results


def write_record(path, record) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# Serving trunk: preprocessing fold, per-block roofline, "
                "convolution setting (SSD300 batch 8, bf16)\n\n")
        f.write(
            f"Card: {record['card']}. Block timings by device time "
            "(`utils/profiling.time_calls`: CUDA events around calls "
            "enqueued while the card is held). `floor_ms` = max(tensor-core "
            f"floor at {PEAK_BF16_TFLOPS:.0f} TFLOP/s bf16, HBM floor at "
            f"{HBM_GBPS:.0f} GB/s; NVIDIA's data sheet for one H100 SXM at "
            "700 W) for the block's FLOPs and bytes. The blocks are the "
            "port's own SSD300 layers and weights on their real inputs.\n\n")
        f.write("```json\n" + json.dumps(record, indent=1) + "\n```\n")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="serving trunk: fold, roofline, settings")
    p.add_argument("--flags", action="store_true",
                   help="also sweep the convolution setting (fresh processes)")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "serving_trunk.md"))
    add_device_args(p, compute_dtype=None)
    args = p.parse_args(argv)
    device = device_of(args)

    pre = measure_preprocessing(device)
    blocks = measure_blocks(device)
    flags = flag_sweep(device) if args.flags else None

    record = {"card": card_line(device),
              "peaks": {"bf16_tflops": PEAK_BF16_TFLOPS, "hbm_gb_per_s": HBM_GBPS},
              "preprocessing": pre, "blocks": blocks,
              "blocks_total_ms": sum(r["ms"] for r in blocks),
              "blocks_total_floor_ms": sum(r["floor_ms"] for r in blocks)}
    if flags:
        record["flag_sweep"] = flags
    write_record(args.out, record)
    print("RESULT " + json.dumps(record))
    return record


if __name__ == "__main__":
    main()
