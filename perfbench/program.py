"""The program's own spans and counters over a traced window.

While a run's profiler is on, the program records its spans
(``ssd_keras_torch.utils.profiling.span``) into a ring on
``time.perf_counter_ns``, the harness's clock, and notes the counts it
makes (``profiling.count``); each span is also an ``ssd.<name>`` event of
the profiler's trace, on the card's clock. A per-layer reader takes them
from here:

- ``program_s(run)``: for each span name, its ``count``, ``total_s`` and
  ``self_s`` (the total less its child spans') over the spans that started
  inside the traced window (``run.traced["host_t0"]`` and
  ``["host_window_s"]``);
- ``counts(run)``: the counts the program made inside that window;
- ``run.traced["program_idle_s"]``: the card's idle seconds in the window
  by the innermost ``ssd.`` span open over them (``"none"`` where none
  was), which :class:`TracedRun` adds to ``run.traced`` from the trace's
  events (with ``program_s`` and ``counters``, the change of
  ``profiling.counters()`` over the window).

A program that records no spans gives empty results, and the readers
return None.

``harness.Run`` keeps no event of the trace, so ``perfbench.run`` has no
``program_idle_s``; this module's command runs a cell traced through
:class:`TracedRun` and prints it, every per-layer metric of the cell, the
metrics that read ``program_idle_s``, and the stages of the slowest
calls::

    python3 -m perfbench.program --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

from perfbench import harness

PREFIX = "ssd."
# Idle-time metrics that need ``program_idle_s``, with the cell each reads.
IDLE_METRICS = {"serve.idle_in_host_path_pct": "ssd300_voc.serve_overload",
                "eval.idle_in_data_pct": "ssd512_voc.eval_voc07",
                "train.idle_in_step_pct": "ssd300_voc.train_device_aug"}
# The calls whose slowest cases ``main`` breaks down, and the bar.
SLOW_CALLS = ("predict", "data.batch", "eval.dispatch", "eval.drain", "train.step")
SLOW_MS = 15.0


def _profiling():
    """The program's span module, or None where the program has none."""
    from ssd_keras_torch.utils import profiling

    return profiling if hasattr(profiling, "spans") else None


def window_ns(run: harness.Run):
    """The traced window on ``time.perf_counter_ns``, or None."""
    if run.traced is None:
        return None
    lo = int(run.traced["host_t0"] * 1e9)
    return lo, lo + int(run.traced["host_window_s"] * 1e9)


def window_spans(run: harness.Run) -> list:
    """The program's spans that started inside the traced window."""
    profiling, window = _profiling(), window_ns(run)
    if profiling is None or window is None:
        return []
    lo, hi = window
    return [s for s in profiling.spans() if lo <= s.start_ns < hi]


def span_seconds(spans) -> Dict[str, dict]:
    """Count, total and self seconds by span name."""
    out: Dict[str, dict] = {}
    for s in spans:
        row = out.setdefault(s.name, dict(count=0, total_s=0.0, self_s=0.0))
        took = (s.end_ns - s.start_ns) / 1e9
        row["count"] += 1
        row["total_s"] += took
        row["self_s"] += took - s.child_ns / 1e9
    return out


def program_s(run: harness.Run) -> Dict[str, dict]:
    return span_seconds(window_spans(run))


def counts(run: harness.Run) -> Dict[str, int]:
    profiling, window = _profiling(), window_ns(run)
    if profiling is None or window is None:
        return {}
    return profiling.counted(*window)


def total_s(spans: Dict[str, dict], name: str) -> float:
    return spans.get(name, {}).get("total_s", 0.0)


def idle_pct_under(run: harness.Run, names) -> Optional[float]:
    """The share of the traced window in which the card was idle while the
    innermost program span was one of ``names``."""
    if run.traced is None or "program_idle_s" not in run.traced or run.traced["window_s"] <= 0:
        return None
    idle = run.traced["program_idle_s"]
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / run.traced["window_s"]


# ---------------------------------------------------------------------------
# The idle time by program span, from a profiler's events
# ---------------------------------------------------------------------------


def innermost_timeline(spans):
    """``spans`` (start, end, name) on one clock as change points (times,
    names): from ``times[i]`` on, the innermost open span is ``names[i]``
    (the latest started of those open; ``"none"`` where none is)."""
    edges = sorted([(a, 1, i) for i, (a, _, _) in enumerate(spans)]
                   + [(b, 0, i) for i, (_, b, _) in enumerate(spans)])
    open_: List[int] = []
    times: List[int] = []
    names: List[str] = []
    for t, starts, i in edges:
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
        name = spans[max(open_, key=lambda j: spans[j][0])][2] if open_ else "none"
        if times and times[-1] == t:
            names[-1] = name
        else:
            times.append(t)
            names.append(name)
    return times, names


def idle_by_span(gaps, spans) -> Dict[str, float]:
    """Seconds of each gap (start, end) in ns under each innermost span."""
    times, names = innermost_timeline(spans)
    idle: Dict[str, int] = defaultdict(int)
    for a, b in gaps:
        i = bisect.bisect_right(times, a) - 1
        at, name = a, (names[i] if i >= 0 else "none")
        for j in range(i + 1, len(times)):
            if times[j] >= b:
                break
            idle[name] += times[j] - at
            at, name = times[j], names[j]
        idle[name] += b - at
    return {k: v / 1e9 for k, v in idle.items()}


def program_idle_s(events) -> dict:
    """From a trace's events (start_ns, end_ns, name, on_card): the window
    (the harness's ``pb.window``), the card's busy seconds in it (neither
    span's mirrors counted), its idle seconds by innermost program span,
    and how many card events carry a program span's name."""
    host = [(a, b, n) for a, b, n, card in events if not card]
    windows = [(a, b) for a, b, n in host if n == harness.SPAN_PREFIX + "window"]
    lo, hi = windows[0] if windows else (min(a for a, _, _ in host), max(b for _, b, _ in host))
    merged: List[List[int]] = []
    for a, b, n in sorted(e[:3] for e in events if e[3]):
        if n.startswith((harness.SPAN_PREFIX, PREFIX)):
            continue
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps, at = [], lo
    for a, b in merged:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    spans = [(a, b, n[len(PREFIX):]) for a, b, n in host if n.startswith(PREFIX)]
    return dict(window_s=(hi - lo) / 1e9, busy_s=sum(b - a for a, b in merged) / 1e9,
                idle_s=idle_by_span(gaps, spans),
                card_events_named_as_spans=sum(1 for e in events
                                               if e[3] and e[2].startswith(PREFIX)))


def trace_events(prof) -> list:
    """(start_ns, end_ns, name, on_card) of each event of a stopped profiler."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = harness._ns(e, "start")
        out.append((start, start + harness._ns(e, "duration"), e.name(), e.device_type() == cuda))
    return out


class TracedRun(harness.Run):
    """A run whose traced window also keeps, in ``traced``,
    ``program_idle_s``, ``program_s`` and ``counters``."""

    def profiler(self):
        prof = super().profiler()
        if prof is not None and _profiling() is not None:
            prof._pb_counters = _profiling().counters()
        return prof

    def stop_profiler(self, prof) -> None:
        super().stop_profiler(prof)
        reduced = program_idle_s(trace_events(prof))
        self.traced.update(program_idle_s=reduced["idle_s"], program_busy_s=reduced["busy_s"],
                           card_events_named_as_spans=reduced["card_events_named_as_spans"],
                           program_s=program_s(self))
        before = getattr(prof, "_pb_counters", None)
        if before is not None:
            after = _profiling().counters()
            self.traced["counters"] = {k: v - before.get(k, 0) for k, v in after.items()
                                       if v != before.get(k, 0)}


def slow_calls(spans, names=SLOW_CALLS, over_ms: float = SLOW_MS) -> Dict[str, dict]:
    """For each call name, how many calls took over ``over_ms`` and, of
    those, the child span that took the most of each (``self`` where the
    call's own time did), with that child's milliseconds."""
    by_parent = defaultdict(list)
    for s in spans:
        by_parent[(s.parent, s.id)].append(s)
    out: Dict[str, dict] = {}
    for s in spans:
        took = (s.end_ns - s.start_ns) / 1e6
        if s.name not in names or took <= over_ms:
            continue
        children = [c for c in by_parent[(s.name, s.id)]
                    if s.start_ns <= c.start_ns and c.end_ns <= s.end_ns]
        own = took - s.child_ns / 1e6
        top = max(children, key=lambda c: c.end_ns - c.start_ns, default=None)
        name, ms = ("self", own)
        if top is not None and (top.end_ns - top.start_ns) / 1e6 > own:
            name, ms = top.name, (top.end_ns - top.start_ns) / 1e6
        row = out.setdefault(s.name, dict(calls=0, over=0, by=defaultdict(list)))
        row["over"] += 1
        row["by"][name].append(round(ms, 3))
    for s in spans:
        if s.name in out:
            out[s.name]["calls"] += 1
    for row in out.values():
        row["by"] = dict(row["by"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    args.trace = 1
    started = time.perf_counter()
    import torch

    profiling = _profiling()
    if profiling is None:
        print("perfbench.program: the program records no spans", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("perfbench.program: no CUDA device", file=sys.stderr)
        return 2
    man = harness.manifest()
    cell = harness.load_json("cells", args.workload)
    config = harness.load_json("configs", cell["config"])
    run = TracedRun(args, args.workload, cell, config, started)
    with profiling.recording():  # the whole run, for the slow calls
        harness.load_module("drivers", cell["driver"]).run(run)
        everything = profiling.spans()
    if run.traced is None:
        print("perfbench.program: the run recorded no traced window", file=sys.stderr)
        return 2
    names = [m["name"] for m in harness.cell_metrics(man, args.workload)[1]]
    names += [n for n, c in IDLE_METRICS.items() if c == args.workload]
    metrics = {}
    for name in names:
        value = harness.load_module("metrics", name).read(run)
        metrics[name] = None if value is None else float(value)
    idle = run.traced["window_s"] - run.traced["busy_s"]
    named = idle - run.traced["program_idle_s"].get("none", 0.0)
    out = dict(workload=args.workload, seed=args.seed, correct=run.correct, metrics=metrics,
               window_s=run.traced["window_s"], busy_s=run.traced["busy_s"],
               program_busy_s=run.traced["program_busy_s"],
               idle_named_share=named / idle if idle > 0 else None,
               card_events_named_as_spans=run.traced["card_events_named_as_spans"],
               program_idle_s=dict(sorted(run.traced["program_idle_s"].items(),
                                          key=lambda kv: -kv[1])),
               program_s=run.traced["program_s"], counters=run.traced.get("counters", {}),
               slow_calls=slow_calls(everything), idle_gaps=harness.breakdown(run.traced)[
                   "idle_gaps"],
               card=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
