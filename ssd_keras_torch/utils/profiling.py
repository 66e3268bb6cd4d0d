"""Profiling and timing utilities (PyTorch).

Port of ``ssd_keras_tpu/utils/profiling.py``:

* :func:`trace` -- a ``torch.profiler`` context that writes a Chrome trace
  (open it in Perfetto, ``chrome://tracing`` or TensorBoard's profile
  plugin),
* :func:`device_sync` -- ``torch.cuda.synchronize``; a CPU tensor needs no
  wait,
* :func:`benchmark_fps` -- images a second of ``forward(batch)``, with the
  JAX function's keys, timed by CUDA events on the card and the host clock
  on the CPU,
* :func:`time_cuda` and :func:`time_device` -- milliseconds a call by CUDA
  events, of whole calls back to back or of device time alone, and
  :func:`summary` of their repeats,
* :func:`time_calls` -- a function's device time on the card (the hold
  lengthened to fit its enqueue), its host-clock time on the CPU, with the
  timer named.

The JAX package's ``time_in_jit`` and its chained-checksum timing work
around a remote TPU whose ``block_until_ready`` does not block; CUDA events
need neither, so they are not ported.
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["trace", "device_sync", "benchmark_fps", "time_cuda", "time_device", "time_calls",
           "summary"]

# Cycles of torch.cuda._sleep that hold the card while time_device enqueues:
# at least 10 ms at the H100's highest SM clock.
HOLD_CYCLES = 20_000_000
MAX_SM_CLOCK_HZ = 1.98e9


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the body (CPU, and CUDA when a card is present) and write its
    Chrome trace into ``log_dir`` (default: ``torch-trace`` under the system
    temp dir) on exit, also when the body raises. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def device_sync(x=None) -> None:
    """Wait until the card has run all queued work: on ``x``'s device for a
    tensor, on the current device when ``x`` is None and a card is
    present. A CPU tensor needs no wait."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
    elif torch.cuda.is_available():
        torch.cuda.synchronize()


def time_cuda(fn: Callable, iters: int, repeats: int = 5, warmup: int = 3):
    """Milliseconds per call of ``fn``, one value per repeat: CUDA events
    around ``iters`` calls back to back (where the host's time per call may
    set the pace)."""
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


@contextlib.contextmanager
def _gc_paused():
    """The garbage collector off for the body, as ``timeit`` runs: in a
    process with a large heap one full collection can outlast a hold."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def time_device(fn: Callable, iters: int, repeats: int = 5, warmup: int = 3,
                hold_cycles: int = HOLD_CYCLES):
    """Milliseconds of device time per call of ``fn``, one value per repeat:
    CUDA events around ``iters`` calls that the host enqueues while the card
    is held busy (``torch.cuda._sleep`` of ``hold_cycles``), so the host's
    own time per call is not counted. Raises if the host took longer than
    half the hold to enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with _gc_paused():
            torch.cuda._sleep(hold_cycles)
            t0 = time.perf_counter()
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            host_s = time.perf_counter() - t0
        end.synchronize()
        if host_s > hold_cycles / MAX_SM_CLOCK_HZ / 2:
            raise AssertionError(f"enqueueing {iters} calls took {1e3 * host_s:.2f} ms of host "
                                 "time, too close to the hold: the device time would include it")
        runs.append(start.elapsed_time(end) / iters)
    return runs


def time_calls(fn: Callable, device, iters: int, repeats: int = 5, warmup: int = 3) -> dict:
    """Milliseconds per call of ``fn`` on ``device``, as :func:`summary` of
    the repeats plus ``iters``, ``timer`` and ``hold_ms``.

    On the card: :func:`time_device` over ``iters`` calls, its hold at least
    eight times the host's slowest enqueue of those calls in three passes
    under a hold (a shared host's speed wanders), so the enqueue fits. Keep ``iters``
    times the kernels a call launches well under the launch queue's ~1000
    entries: a full queue blocks the host until the hold ends. On the CPU:
    the host clock around ``iters`` calls, since there the host does the
    work."""
    device = torch.device(device)
    if device.type != "cuda":
        for _ in range(warmup):
            fn()
        runs = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            runs.append(1e3 * (time.perf_counter() - t0) / iters)
        return dict(summary(runs), iters=iters, timer="host clock (cpu)", hold_ms=None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    enqueue_s = 0.0
    for _ in range(3):
        with _gc_paused():
            torch.cuda._sleep(HOLD_CYCLES)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            enqueue_s = max(enqueue_s, time.perf_counter() - t0)
        torch.cuda.synchronize()
    hold = max(HOLD_CYCLES, int(8 * enqueue_s * MAX_SM_CLOCK_HZ))
    runs = time_device(fn, iters, repeats, warmup=0, hold_cycles=hold)
    return dict(summary(runs), iters=iters, timer="cuda events, card held",
                hold_ms=1e3 * hold / MAX_SM_CLOCK_HZ)


def summary(runs):
    """Median, min, max and spread (% of the median) of repeated timings."""
    med = statistics.median(runs)
    return dict(median=med, min=min(runs), max=max(runs),
                spread_pct=100 * (max(runs) - min(runs)) / med, runs=runs)


def benchmark_fps(
    forward: Callable,
    example_batch,
    n_iters: int = 30,
    n_repeats: int = 3,
    warmup: int = 2,
    batch_size: Optional[int] = None,
) -> dict:
    """Images a second of ``forward(batch)``, run under ``torch.no_grad``.

    ``example_batch`` (a tensor, or an array taken to a CPU tensor) is passed
    as it is, so it sets the device. On the card each repeat is ``n_iters``
    calls between two CUDA events; on the CPU the host clock times them.
    The best repeat gives ``fps`` and ``ms_per_batch``; ``times_s`` holds
    every repeat's seconds.
    """
    batch = example_batch
    if not isinstance(batch, torch.Tensor):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if batch_size is None:
        batch_size = int(batch.shape[0])

    def call():
        forward(batch)

    with torch.no_grad():
        if batch.device.type == "cuda":
            times = [ms * n_iters / 1e3 for ms in time_cuda(call, n_iters, n_repeats, warmup)]
        else:
            for _ in range(warmup):
                call()
            times = []
            for _ in range(n_repeats):
                start = time.perf_counter()
                for _ in range(n_iters):
                    call()
                times.append(time.perf_counter() - start)

    best = min(times)
    return {
        "fps": batch_size * n_iters / best,
        "ms_per_batch": best / n_iters * 1000.0,
        "batch_size": batch_size,
        "n_iters": n_iters,
        "times_s": times,
    }
