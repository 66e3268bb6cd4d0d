#!/usr/bin/env python3
"""Time this tree's greedy-NMS kernel against another tree's on one card, interleaved.

    git archive <commit> ssd_keras_torch | tar -x -C _archive/parent
    python3 nms_ab.py _archive/parent/ssd_keras_torch

The other tree is a copy of the package: its own ``kernels/build.py`` builds
its own ``csrc/`` into its own ``_build/``, and its own ``kernels/nms.py``
wrapper (bound to that build) is called. At the five shapes of
``chip_smoke.py``'s phase 6, after checking that both give the same keep
mask, in rounds of parent, change, change, parent: the device time per call
(``utils.profiling.time_device``) and the time of whole calls back to back
(``utils.profiling.time_cuda``); then each kernel's device time per call
(``torch.profiler``) and the host's time to enqueue a call while the card is
held. Then how this tree's wrapper spends its host time on the sparse
lanes, step by step. Then SSD300 VOC bf16 serving at batch 8
(``chip_smoke.py``'s main path) with the decoder's NMS switched between the
two wrappers, in the same rounds. Prints the card, one JSON line per shape,
one for the host split and one for serving, and last ``{"ok": true, ...}``.
"""

import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from ssd_keras_torch import decoder
from ssd_keras_torch.kernels import build
from ssd_keras_torch.kernels import nms as nms_kernel
from ssd_keras_torch.utils.profiling import summary, time_cuda, time_device

ROUNDS = 3
ITERS = 50
SERVING_ROUNDS = 30
SERVING_ITERS = 20
PROFILED_CALLS = 20
ENQUEUED_CALLS = 50
KERNELS = ("nms_iou_mask", "nms_resolve", "greedy_nms_kernel")


def device_us(fn):
    """Device time per call of each NMS kernel that ``fn`` launches, in us."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    found = {}
    for event in prof.key_averages():
        for name in KERNELS:
            if name in event.key:
                found[name] = found.get(name, 0.0) + event.device_time_total / PROFILED_CALLS
    return found or "not measured"


def enqueue_us(fn, calls=ENQUEUED_CALLS):
    """Host time per call to enqueue ``calls`` calls of ``fn`` while the card
    is held (``torch.cuda._sleep``), so that no launch waits for the device;
    in us, host clock."""
    torch.cuda.synchronize()
    torch.cuda._sleep(cs.HOLD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    if host > cs.HOLD_CYCLES / cs.MAX_SM_CLOCK_HZ / 2:
        raise AssertionError(f"enqueueing {calls} calls took {1e3 * host:.2f} ms, too close "
                             "to the hold")
    return 1e6 * host / calls


def host_split(b, v, card):
    """This tree's wrapper on ``(b, v)``: its host time per call, and the
    host time of each step it takes (and of what it replaced), enqueued
    while the card is held; prints one JSON line."""
    lanes, k = v.shape
    index = b.device.index
    stream = build.raw_stream(index)
    words = lanes * k * nms_kernel.mask_words(k)
    keep = torch.empty_like(v)
    mask = torch.empty(words, dtype=torch.int64, device=b.device)
    lib = build.load_library()
    args = (b.data_ptr(), v.data_ptr(), keep.data_ptr(), mask.data_ptr(), lanes, k,
            cs.IOU_THRESHOLD, 0.0, stream)

    def device_context():
        with torch.cuda.device(b.device):
            pass

    steps = {
        "wrapper": lambda: nms_kernel.greedy_nms_mask_batched(b, v, cs.IOU_THRESHOLD),
        "checks": lambda: (nms_kernel._check(b, v), nms_kernel._check_cuda(b)),
        "empty_like_keep": lambda: torch.empty_like(v),
        "kept_scratch": lambda: nms_kernel._scratch(index, stream, words),
        "raw_stream": lambda: build.raw_stream(index),
        "current_device": torch.cuda.current_device,
        "c_entry_two_launches": lambda: lib.ssd_greedy_nms(*args),
        "c_entry_pass_a_only": lambda: lib.ssd_nms_iou_mask(*args[:2], *args[3:]),
        # What the wrapper no longer does each call.
        "empty_scratch": lambda: torch.empty(words, dtype=torch.int64, device=b.device),
        "device_context": device_context,
        "current_stream_object": lambda: torch.cuda.current_stream().cuda_stream,
    }
    line = dict(metric="nms_host_split_us", lanes=lanes, k=k, valid=int(v.sum()),
                **{name: statistics.median(enqueue_us(fn) for _ in range(5))
                   for name, fn in steps.items()}, card=card)
    print(json.dumps(line), flush=True)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def parent_nms(package_dir):
    """The other tree's ``greedy_nms_mask_batched``: its ``kernels/nms.py``,
    which imports ``ssd_keras_torch.kernels.build`` by name, loaded while
    that name points at the other tree's ``kernels/build.py``."""
    package = Path(package_dir)
    other = _load("parent_build", package / "kernels" / "build.py")
    name = "ssd_keras_torch.kernels.build"
    ours = sys.modules[name]
    sys.modules[name] = other
    try:
        wrapper = _load("parent_nms", package / "kernels" / "nms.py")
    finally:
        sys.modules[name] = ours
    # A newer tree's wrapper takes ``launch``, an older one ``load_library``.
    taken = [fn for fn in ("launch", "load_library") if hasattr(wrapper, fn)]
    if not taken or getattr(wrapper, taken[0]) is not getattr(other, taken[0]):
        raise RuntimeError(f"{package / 'kernels' / 'nms.py'} does not take its launch from "
                           "ssd_keras_torch.kernels.build: this loader would time this tree's "
                           "kernel as the other's")
    return wrapper.greedy_nms_mask_batched, other.BUILD_DIR


def serving_ab(parent, serving, x, card):
    """SSD300 bf16 serving at batch 8 with the decoder's NMS from the other
    tree and from this one, interleaved; prints one JSON line."""
    ours = decoder.greedy_nms_mask_batched
    runs = {"parent": [], "change": []}
    try:
        for _ in range(SERVING_ROUNDS):
            for side, nms in (("parent", parent), ("change", ours), ("change", ours),
                              ("parent", parent)):
                decoder.greedy_nms_mask_batched = nms
                runs[side] += time_cuda(lambda: serving(x), iters=SERVING_ITERS, repeats=1,
                                           warmup=1)
    finally:
        decoder.greedy_nms_mask_batched = ours
    batch = x.shape[0]
    line = dict(metric="nms_ab_serving", model="SSD300 VOC", dtype="bf16", batch=batch,
                **{f"{side}_img_per_s": batch * 1e3 / statistics.median(r)
                   for side, r in runs.items()},
                **{f"{side}_ms": summary(r) for side, r in runs.items()},
                change_faster_in=sum(c < p for c, p in zip(runs["change"], runs["parent"])),
                of=len(runs["change"]),
                change_over_parent_median=statistics.median(
                    c / p for c, p in zip(runs["change"], runs["parent"])),
                card=card)
    print(json.dumps(line), flush=True)


def main():
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        raise SystemExit(__doc__)
    device = torch.device("cuda")
    torch.set_grad_enabled(False)
    card = cs.card_info()
    print(card, flush=True)
    parent, parent_build = parent_nms(sys.argv[1])
    print(f"parent built in {parent_build}", flush=True)

    state = cs.seeded_state()
    serving = cs.model_for(state, "inference", torch.bfloat16, device)
    x_host = np.random.RandomState(cs.SEED + 1).randint(0, 256, (cs.BATCH, 300, 300, 3))
    x = torch.from_numpy(x_host.astype(np.float32)).to(device)
    shapes = cs.nms_shapes(device, serving, x)

    for name, (b, v) in shapes.items():
        def change():
            return nms_kernel.greedy_nms_mask_batched(b, v, cs.IOU_THRESHOLD)

        def old():
            return parent(b, v, cs.IOU_THRESHOLD)

        keep = change()
        if not torch.equal(keep, old()):
            raise AssertionError(f"{name}: the parent's keep mask differs from this tree's")
        timers = {"device": time_device, "call": time_cuda}
        runs = {(timer, side): [] for timer in timers for side in ("parent", "change")}
        for _ in range(ROUNDS):
            for side, fn in (("parent", old), ("change", change), ("change", change),
                             ("parent", old)):
                for timer, time_fn in timers.items():
                    runs[timer, side] += time_fn(fn, iters=ITERS, repeats=1, warmup=2)
        cost = cs.nms_bound(v, keep)
        line = dict(metric="nms_ab_ms", shape=name, lanes=v.shape[0], k=v.shape[1],
                    valid=int(v.sum()), **cost)
        for timer in timers:
            parent_runs, change_runs = runs[timer, "parent"], runs[timer, "change"]
            med = statistics.median(change_runs)
            line[timer] = dict(
                parent_ms=summary(parent_runs), change_ms=summary(change_runs),
                speedup=statistics.median(parent_runs) / med,
                change_faster_in=sum(c < p for c, p in zip(change_runs, parent_runs)),
                of=len(change_runs), bound_share_change=cost["bound_ms"] / med)
        line.update(profiled_us=dict(parent=device_us(old), change=device_us(change)),
                    enqueue_us=dict(parent=enqueue_us(old), change=enqueue_us(change)),
                    card=card)
        print(json.dumps(line), flush=True)
    host_split(*shapes["sparse_L160"], card)
    serving_ab(parent, serving, x, card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
