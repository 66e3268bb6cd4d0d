"""Profiling and timing utilities (PyTorch).

Port of ``ssd_keras_tpu/utils/profiling.py``:

* :func:`trace` -- a ``torch.profiler`` context that writes a Chrome trace
  (open it in Perfetto, ``chrome://tracing`` or TensorBoard's profile
  plugin), the program's spans in it,
* :func:`span`, :func:`spanned`, :func:`count`, :func:`counters`, :func:`spans`,
  :func:`counted` and :func:`recording` -- the program's spans and counters
  at its layer boundaries (below),
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

Spans and counters. ``with span("predict.stack"):`` marks a host stage of
the program. Off, the default, a span is one check of a flag and of
``torch.autograd._profiler_enabled()`` and a shared no-op context: it
allocates nothing and reads no clock. It records while :func:`recording`
is active or a ``torch.profiler`` runs: a :class:`Span` (name, start and
end on ``time.perf_counter_ns``, the enclosing span's name, the id of the
request, batch or step, inherited from the enclosing span, and the time its
child spans took) into a bounded ring that :func:`spans` returns. While a
profiler runs it is also an event ``ssd.<name>`` of the profiler's own
trace, on the clock of the card's kernels: a function-scope record, which
the profiler does not mirror onto the card's timeline as it mirrors
``torch.profiler.record_function``. :func:`count` adds to a counter and is
always on; while spans record it also notes the time, so :func:`counted`
gives the counts of a window. :func:`counters` reads them. They are the
program's only counters: the kernels' wrappers count their launches here
too. Inside :func:`held` the counts this thread makes are kept apart
instead, and :func:`count_all` counts them later: a CUDA graph holds its
capture's counts and counts them again at each replay
(``utils/cuda_graph.py``). Spans run per request, batch or step, never per
box or pixel, and none stays open across a ``yield``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import os
import statistics
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["trace", "device_sync", "benchmark_fps", "time_cuda", "time_device", "time_calls",
           "summary", "Span", "span", "spanned", "count", "count_all", "counters", "counted",
           "held", "spans", "recording"]

# Cycles of torch.cuda._sleep that hold the card while time_device enqueues:
# at least 10 ms at the H100's highest SM clock.
HOLD_CYCLES = 20_000_000
MAX_SM_CLOCK_HZ = 1.98e9


# Spans kept in the ring, and counts noted while spans record: a traced
# serving window of 2 s holds some 5,000 spans.
RING_SIZE = 1 << 17
# Prefix of the program's spans in a profiler's trace.
SPAN_PREFIX = "ssd."


class Span(NamedTuple):
    """One recorded span: times on ``time.perf_counter_ns``; ``parent`` the
    enclosing span's name (None at the top); ``id`` the request, batch or
    step it belongs to; ``child_ns`` the time its child spans took, so its
    self time is ``end_ns - start_ns - child_ns``."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    id: Optional[int]
    child_ns: int


_ring: deque = deque(maxlen=RING_SIZE)
_noted: deque = deque(maxlen=RING_SIZE)  # (time_ns, name, n) while spans record
_counts: Dict[str, int] = {}
_counts_lock = threading.Lock()
_recording = 0  # depth of active recording() contexts
_holding = 0  # depth of active held() contexts, on every thread
_local = threading.local()
_profiler_enabled = torch.autograd._profiler_enabled


_OFF = contextlib.nullcontext()  # the shared context of a span that does not record


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span that records: pushed on this thread's stack of open spans."""

    __slots__ = ("name", "id", "parent", "start", "child_ns", "event")

    def __init__(self, name: str, id: Optional[int]):
        self.name, self.id = name, id

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.id is None and outer is not None:
            self.id = outer.id
        self.child_ns = 0
        self.event = None
        if _profiler_enabled():
            self.event = torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + self.name)
            self.event.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        if self.event is not None:
            self.event.__exit__(*exc)
        took = end - self.start
        if stack:
            stack[-1].child_ns += took
        _ring.append(Span(self.name, self.start, end, self.parent, self.id, self.child_ns))
        return False


def span(name: str, id: Optional[int] = None):
    """A context that records the stage ``name`` (see the module's
    docstring); ``id`` names the request, batch or step, else the enclosing
    span's is taken."""
    if not (_recording or _profiler_enabled()):
        return _OFF
    return _Open(name, id)


def spanned(name: str):
    """A decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``; while spans record, also note when.
    Inside :func:`held` on this thread, add it to the held counts instead."""
    if _holding:
        kept = getattr(_local, "held", None)
        if kept:
            kept[-1][name] = kept[-1].get(name, 0) + n
            return
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n
    if _recording or _profiler_enabled():
        _noted.append((time.perf_counter_ns(), name, n))


def count_all(counts: Dict[str, int]) -> None:
    """:func:`count` each of ``counts`` (``name -> n``) once: the counts a
    :func:`held` body made, made again."""
    for name, n in counts.items():
        count(name, n)


@contextlib.contextmanager
def held():
    """Yields a dict that takes, as ``name -> n``, every :func:`count` this
    thread makes in the body (the innermost ``held`` where they nest), in
    place of the counters and the noted window. Other threads count as
    usual."""
    global _holding
    kept = getattr(_local, "held", None)
    if kept is None:
        kept = _local.held = []
    counts: Dict[str, int] = {}
    kept.append(counts)
    with _counts_lock:
        _holding += 1
    try:
        yield counts
    finally:
        with _counts_lock:
            _holding -= 1
        kept.pop()


def counters() -> Dict[str, int]:
    """A snapshot of every counter :func:`count` made, among them the
    kernels' launches (``nms.launches``, ``conv_epilogue.launches``,
    ``jpeg_color.launches``, ``resize_linear.launches``) and
    ``nvjpeg.batches`` (``nvjpegDecodeBatched`` calls). A counter nothing
    has counted yet is absent."""
    with _counts_lock:
        return dict(_counts)


def counted(start_ns: int = 0, end_ns: Optional[int] = None) -> Dict[str, int]:
    """The counts :func:`count` made while spans recorded, from ``start_ns``
    up to ``end_ns`` on ``time.perf_counter_ns``."""
    out: Dict[str, int] = {}
    for t, name, n in list(_noted):
        if start_ns <= t and (end_ns is None or t < end_ns):
            out[name] = out.get(name, 0) + n
    return out


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most ``RING_SIZE``, the newest)."""
    return list(_ring)


@contextlib.contextmanager
def recording():
    """Spans record inside the body, with no profiler; the ring and the
    noted counts are cleared on entry."""
    global _recording
    _ring.clear()
    _noted.clear()
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the body (CPU, and CUDA when a card is present) and write its
    Chrome trace into ``log_dir`` (default: ``torch-trace`` under the system
    temp dir) on exit, also when the body raises. Yields ``log_dir``. The
    trace holds the program's spans as ``ssd.<name>`` events beside the
    card's kernels, on one clock: the way to see which host stage the card
    waits on."""
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
