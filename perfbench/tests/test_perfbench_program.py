"""The program's spans and counters as the benchmark reads them
(``perfbench.program``): the idle time by innermost program span on
synthetic trace events, self time, the harness's reduction unmoved by the
program's host events, and each new reader on a tiny run of its cell."""

import types

import pytest

from perfbench import harness, program


class _Event:
    """A Kineto-like event: what ``harness.summarize_trace`` reads."""

    def __init__(self, start, end, name, card):
        self._start, self._end, self._name, self._card = start, end, name, card

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._card else torch.autograd.DeviceType.CPU


def _prof(events):
    results = types.SimpleNamespace(events=lambda: [_Event(*e) for e in events])
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


# One request in a 100-unit window: the harness's span over it, the program's
# stages inside, two kernels on the card and the harness's mirror of its span.
WINDOW = [(0, 100, "pb.window", False), (5, 95, "pb.predict", False),
          (5, 95, "ssd.predict", False), (10, 30, "ssd.predict.stack", False),
          (30, 40, "ssd.predict.pin", False), (40, 50, "ssd.predict.launch", False),
          (50, 90, "ssd.predict.read", False),
          (45, 60, "kernel_a", True), (70, 80, "kernel_b", True),
          (45, 80, "pb.predict", True)]


def test_idle_goes_to_the_innermost_program_span_and_sums_to_the_window_idle():
    got = program.program_idle_s(WINDOW)
    assert got["window_s"] == pytest.approx(100e-9) and got["busy_s"] == pytest.approx(25e-9)
    idle = {k: round(v * 1e9) for k, v in got["idle_s"].items()}
    assert idle == {"none": 10, "predict": 5 + 5, "predict.stack": 20, "predict.pin": 10,
                    "predict.launch": 5, "predict.read": 10 + 10}
    assert sum(idle.values()) == 100 - 25
    assert got["card_events_named_as_spans"] == 0


def test_mirrors_of_either_span_on_the_card_are_not_card_work():
    mirrored = WINDOW + [(45, 80, "ssd.predict", True), (45, 60, "ssd.predict.launch", True)]
    assert program.program_idle_s(mirrored)["busy_s"] == program.program_idle_s(WINDOW)["busy_s"]
    assert program.program_idle_s(mirrored)["card_events_named_as_spans"] == 2


def test_the_harness_reduction_is_unmoved_by_the_programs_host_spans():
    bare = [e for e in WINDOW if not e[2].startswith("ssd.")]
    with_spans, without = harness.summarize_trace(_prof(WINDOW)), harness.summarize_trace(
        _prof(bare))
    for key in ("window_s", "busy_s", "kernel_s", "idle_s"):
        assert with_spans[key] == without[key]
    assert harness.breakdown(with_spans) == harness.breakdown(without)


def test_innermost_timeline_takes_the_latest_started_span():
    times, names = program.innermost_timeline([(0, 10, "a"), (2, 5, "b"), (5, 8, "c")])
    assert list(zip(times, names)) == [(0, "a"), (2, "b"), (5, "c"), (8, "a"), (10, "none")]


def test_self_time_is_the_total_less_the_childrens():
    from ssd_keras_torch.utils.profiling import Span

    spans = [Span("leaf", 2, 5, "mid", 1, 0), Span("mid", 1, 7, "top", 1, 3),
             Span("top", 0, 10, None, 1, 6), Span("mid", 11, 12, "top", 2, 0)]
    got = program.span_seconds(spans)
    assert got["top"] == dict(count=1, total_s=pytest.approx(10e-9), self_s=pytest.approx(4e-9))
    assert got["mid"]["count"] == 2 and got["mid"]["total_s"] == pytest.approx(7e-9)
    assert got["mid"]["self_s"] == pytest.approx(4e-9)


def test_slow_calls_name_the_stage_that_held_them():
    from ssd_keras_torch.utils.profiling import Span

    ms = 1_000_000
    spans = [Span("predict.pin", 0, 18 * ms, "predict", 1, 0),
             Span("predict", 0, 20 * ms, None, 1, 18 * ms),
             Span("predict", 30 * ms, 31 * ms, None, 2, 0),
             Span("predict.read", 40 * ms, 42 * ms, "predict", 3, 0),
             Span("predict", 40 * ms, 60 * ms, None, 3, 2 * ms)]
    got = program.slow_calls(spans)
    assert got["predict"]["calls"] == 3 and got["predict"]["over"] == 2
    assert got["predict"]["by"] == {"predict.pin": [18.0], "self": [18.0]}


CELLS = ["ssd300_voc.serve_overload", "ssd512_voc.eval_voc07", "ssd300_voc.train_device_aug"]


@pytest.mark.parametrize("cell", CELLS)
def test_readers_of_the_program_read_a_tiny_run(cell, tiny_run):
    from ssd_keras_torch.utils import profiling

    with profiling.recording():
        t0 = harness.time.perf_counter()
        run = tiny_run(cell, seed=3_000_000_017)
        end = harness.time.perf_counter()
    run.traced = dict(host_t0=t0, host_window_s=end - t0, window_s=end - t0, busy_s=0.0)
    man = harness.manifest()
    layer = [m for m in harness.cell_metrics(man, cell)[1]
             if m["source"] in ("program_span", "program_counter")]
    assert layer
    for m in layer:
        value = harness.load_module("metrics", m["name"]).read(run)
        assert value is not None and value >= 0, m["name"]
    counts = program.counts(run)
    if cell.startswith("ssd300_voc.serve"):
        slots = counts["predict.slots"]
        padded = harness.load_module("metrics", "serve.padded_slot_pct").read(run)
        assert padded == pytest.approx(100 * (slots - counts["predict.images"]) / slots)
        assert harness.load_module("metrics", "serve.graph_captures").read(run) == 0
    # Without a traced window, or without program_idle_s, a reader finds nothing.
    run.traced = None
    for m in layer:
        assert harness.load_module("metrics", m["name"]).read(run) is None
    for name, c in program.IDLE_METRICS.items():
        if c == cell:
            assert harness.load_module("metrics", name).read(run) is None
