"""What every cell shares: finding its files by name, the run's spans and
readings, the reduction of a profiler trace, and the result line.

A cell names a configuration (``configs/<config>.json``) and a driver
(``drivers/<driver>.py``, a module with ``run(run)``) in its own file
(``cells/<cell>.json``); each per-layer metric is a reader of its own
(``metrics/<metric>.py``, a module with ``read(run)`` that returns a
number, or None where it finds nothing to read). All are found by the
names in ``BENCHMARK.json`` and the cell's file: the registry is the
directories, not a list in code.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# Top-level module names that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "ssd_keras_tpu")
# Prefix of the harness's own spans in a profiler trace.
SPAN_PREFIX = "pb."


def manifest() -> dict:
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module; ``name`` may hold dots."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(man: dict, cell: str):
    """The end-to-end and per-layer metrics (manifest entries) that ``cell``
    reports: an end-to-end metric with no ``workloads`` is every cell's; a
    per-layer metric is reported by the cells its ``workloads`` lists."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    layer = [m for m in man["per_layer"] if cell in m["workloads"]]
    return e2e, layer


def forbidden_modules() -> List[str]:
    """The forbidden top-level names among the loaded modules, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def torch_device(name: str):
    import torch

    return torch.device(name)


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ns(event, what: str) -> int:
    f = getattr(event, f"{what}_ns", None)
    return int(f()) if f is not None else int(1000 * getattr(event, f"{what}_us")())


def summarize_trace(prof) -> dict:
    """Busy and idle time of the card over the traced window (the harness's
    ``pb.window`` span), device time by kernel name, host calls by name,
    and the idle time by what the host was doing (the innermost harness
    span over each idle gap)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        item = (start, start + _ns(e, "duration"), e.name())
        if e.device_type() != cuda:
            host.append(item)
        elif not item[2].startswith(SPAN_PREFIX):  # not a span's mirror on the card
            dev.append(item)
    windows = [(a, b) for a, b, n in host if n == SPAN_PREFIX + "window"]
    lo, hi = (windows[0] if windows else (min(a for a, _, _ in host), max(b for _, b, _ in host)))
    kernel_ns: Dict[str, int] = defaultdict(int)
    merged = []
    for a, b, name in sorted(dev):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        kernel_ns[name] += b - a
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps, at = [], lo
    for a, b in merged:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    spans = [(a, b, n[len(SPAN_PREFIX):]) for a, b, n in host
             if n.startswith(SPAN_PREFIX) and n != SPAN_PREFIX + "window"]
    idle: Dict[str, int] = defaultdict(int)
    for a, b in gaps:
        mid = (a + b) // 2
        over = [s for s in spans if s[0] <= mid < s[1]]
        idle[max(over)[2] if over else "other host work"] += b - a
    return dict(
        window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
        kernel_s={k: v / 1e9 for k, v in kernel_ns.items()},
        host_calls=Counter(n for _, _, n in host),
        idle_s={k: v / 1e9 for k, v in idle.items()},
    )


class Run:
    """One run of a cell: its arguments and files, the spans and values
    the driver records, the readings the check compares, the trace."""

    def __init__(self, args, cell_name: str, cell: dict, config: dict, started: float):
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.device = torch_device(getattr(args, "device", "cuda"))
        self.cell_name, self.cell, self.config = cell_name, cell, config
        self.started = started
        self.setup_s: Optional[float] = None
        self.e2e: Dict[str, float] = {}
        self.values: Dict[str, float] = {}
        self.spans: Dict[str, list] = defaultdict(list)
        self.checks: List[dict] = []
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.traced: Optional[dict] = None

    def setup_done(self) -> None:
        """The end of set-up: the next thing the driver does is timed."""
        self.setup_s = time.perf_counter() - self.started

    @contextlib.contextmanager
    def span(self, name: str):
        """A host-clock span around a call into the program; in a traced
        run also a ``pb.<name>`` range in the profiler's trace."""
        t0 = time.perf_counter()
        if self.trace:
            import torch

            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield
        self.spans[name].append((t0, time.perf_counter()))

    def warm_profiler(self) -> None:
        """In a traced run, start and stop the profiler once at set-up: its
        first start loads and initialises CUPTI, which takes seconds."""
        if self.trace:
            import torch

            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]):
                torch.zeros(1, device=self.device).add_(1)
                synchronize(self.device)

    def profiler(self):
        """A started ``torch.profiler`` when the run is traced, else None.
        Stop it with :meth:`stop_profiler`."""
        if not self.trace:
            return None
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        begin = time.perf_counter()
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof._pb_begin = begin
        prof.start()
        prof._pb_window = record_function(SPAN_PREFIX + "window")
        prof._pb_window.__enter__()
        prof._pb_t0 = time.perf_counter()
        return prof

    def stop_profiler(self, prof) -> None:
        import torch

        torch.cuda.synchronize()
        prof._pb_window.__exit__(None, None, None)
        host_s = time.perf_counter() - prof._pb_t0
        prof.stop()
        self.traced = summarize_trace(prof)
        # host_t0 and host_window_s: the traced window; host_begin and
        # host_cost_s: all the time the profiler took, its start, stop and
        # summary included.
        self.traced.update(host_t0=prof._pb_t0, host_window_s=host_s, host_begin=prof._pb_begin,
                           host_cost_s=time.perf_counter() - prof._pb_begin)

    def traced_spans(self, name: str) -> list:
        """The spans ``name`` that started inside the traced window."""
        if self.traced is None:
            return []
        lo = self.traced["host_t0"]
        hi = lo + self.traced["host_window_s"]
        return [s for s in self.spans.get(name, []) if lo <= s[0] < hi]

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared with the reference and its limit (lower is
        better: the run is correct where every value is at most its limit)."""
        self.checks.append(dict(name=name, value=float(value), limit=float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["value"] <= c["limit"] for c in self.checks)


def breakdown(traced: dict, n: int = 10) -> dict:
    top = sorted(traced["kernel_s"].items(), key=lambda kv: -kv[1])[:n]
    idle = sorted(traced["idle_s"].items(), key=lambda kv: -kv[1])[:n]
    return dict(device_ops=[[k, v] for k, v in top], idle_gaps=[[k, v] for k, v in idle])


def idle_pct(run: Run) -> Optional[float]:
    """The share of the traced window in which no operation ran on the card."""
    if run.traced is None or run.traced["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.traced["busy_s"] / run.traced["window_s"])


def kernel_seconds(run: Run, *names: str) -> float:
    """Device time in the traced window of the kernels whose names hold one
    of ``names``."""
    if run.traced is None:
        return 0.0
    return sum(s for k, s in run.traced["kernel_s"].items() if any(n in k for n in names))


def mfu_pct(run: Run, flops_per_image: float) -> Optional[float]:
    """Images done over the window, at ``flops_per_image``, as a share of
    the card's bf16 peak."""
    from perfbench.counts.roofline import BF16_FLOPS

    if not run.values.get("images") or not run.values.get("window_s"):
        return None
    return 100.0 * run.values["images"] * flops_per_image / run.values["window_s"] / BF16_FLOPS


def span_ms(run: Run, name: str) -> List[float]:
    return [1e3 * (b - a) for a, b in run.spans.get(name, [])]
