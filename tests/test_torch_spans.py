"""The program's spans and counters (``ssd_keras_torch.utils.profiling``):
off by default and then a shared no-op that records nothing; on under
``recording()`` or a running ``torch.profiler``, with nesting, parents,
inherited ids, child time and a bounded ring; counters always on, the
kernels' launches among them; ``ssd.*`` events in the profiler's
trace. Then the span tree of the predictor, the evaluator and the trainer
at tiny sizes on the CPU."""

import ast
import inspect
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch
from PIL import Image

from ssd_keras_torch import SSDConfig, SSDInputEncoder, SSDLoss, SSDPredictor, ssd_7
from ssd_keras_torch import train as T
from ssd_keras_torch.data import DataGenerator
from ssd_keras_torch.data.device_aug import DeviceSSDAugmentation
from ssd_keras_torch.encoder import pad_labels
from ssd_keras_torch.eval.evaluator import Evaluator
from ssd_keras_torch.kernels import conv_epilogue, jpeg_color, nms
from ssd_keras_torch.kernels import resize as resize_kernel
from ssd_keras_torch.native import jpeg
from ssd_keras_torch.utils import profiling

torch.set_num_threads(2)

KW = dict(n_classes=3, img_height=64, img_width=64)


def test_off_records_nothing_and_returns_the_shared_no_op():
    before = profiling.spans()
    first, second = profiling.span("a"), profiling.span("b", id=3)
    assert first is second
    with first:
        with second:
            pass
    assert profiling.spans() == before


def test_recording_keeps_nesting_parents_ids_and_child_time():
    with profiling.recording():
        with profiling.span("outer", id=7):
            time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.002)
                with profiling.span("leaf", id=9):
                    pass
            with profiling.span("inner"):
                pass
        got = profiling.spans()
    assert [s.name for s in got] == ["leaf", "inner", "inner", "outer"]
    leaf, inner, inner2, outer = got
    assert (outer.parent, inner.parent, leaf.parent) == (None, "outer", "inner")
    assert (outer.id, inner.id, inner2.id, leaf.id) == (7, 7, 7, 9)
    assert outer.start_ns <= inner.start_ns <= leaf.start_ns <= leaf.end_ns <= inner.end_ns
    assert inner.end_ns <= inner2.start_ns <= inner2.end_ns <= outer.end_ns
    children = (inner.end_ns - inner.start_ns) + (inner2.end_ns - inner2.start_ns)
    assert outer.child_ns == children
    assert inner.child_ns == leaf.end_ns - leaf.start_ns and leaf.child_ns == 0
    assert outer.end_ns - outer.start_ns - outer.child_ns >= 2_000_000  # its own sleep


def test_recording_clears_the_ring_and_it_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_ring", deque(maxlen=4))
    with profiling.recording():
        with profiling.span("old"):
            pass
    with profiling.recording():
        for i in range(6):
            with profiling.span("s", id=i):
                pass
    assert [s.id for s in profiling.spans()] == [2, 3, 4, 5]
    with profiling.recording():
        pass
    assert profiling.spans() == []


def test_a_span_closed_by_an_exception_is_recorded_and_the_stack_unwinds():
    with profiling.recording():
        with pytest.raises(ValueError):
            with profiling.span("fails", id=1):
                raise ValueError("stage failed")
        with profiling.span("next"):
            pass
        got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == [("fails", None), ("next", None)]


def test_counters_are_always_on_and_read_the_kernel_counters():
    before = profiling.counters()
    profiling.count("test.widgets", 2)
    profiling.count("test.widgets")
    after = profiling.counters()
    assert after["test.widgets"] == before.get("test.widgets", 0) + 3
    # Each kernel's wrapper counts its launches through ``count`` under the
    # names the benchmark and the tools read, and nowhere else.
    for module, names in [(nms, {"nms.launches"}), (jpeg_color, {"jpeg_color.launches"}),
                          (resize_kernel, {"resize_linear.launches"}),
                          (jpeg, {"nvjpeg.batches"}),
                          (conv_epilogue, {"conv_epilogue.launches", "conv_epilogue.pooled"})]:
        tree = ast.parse(inspect.getsource(module))
        named = {node.args[0].value for node in ast.walk(tree) if isinstance(node, ast.Call)
                 and isinstance(node.func, ast.Name) and node.func.id == "count"}
        assert named == names, module.__name__


def test_counted_holds_only_counts_made_while_spans_record():
    profiling.count("test.window", 5)  # off: counted, not noted
    with profiling.recording():
        t0 = time.perf_counter_ns()
        profiling.count("test.window", 2)
        t1 = time.perf_counter_ns()
        profiling.count("test.window", 3)
        assert profiling.counted()["test.window"] == 5
        assert profiling.counted(t0, t1) == {"test.window": 2}
        assert profiling.counted(t1) == {"test.window": 3}


def test_counts_inside_held_reach_neither_the_counters_nor_the_window_but_other_threads_do():
    before = profiling.counters()
    with profiling.recording():
        with profiling.held() as kept:
            profiling.count("test.held", 2)
            with profiling.held() as inner:  # the innermost takes them
                profiling.count("test.held", 7)
            profiling.count("test.held.other")
            worker = threading.Thread(target=profiling.count, args=("test.held.thread", 4))
            worker.start()
            worker.join(timeout=10)
            assert not worker.is_alive()
        profiling.count("test.held.after")
        window = profiling.counted()
    after = profiling.counters()
    assert kept == {"test.held": 2, "test.held.other": 1} and inner == {"test.held": 7}
    assert after.get("test.held", 0) == before.get("test.held", 0)
    assert after.get("test.held.other", 0) == before.get("test.held.other", 0)
    assert after["test.held.thread"] == before.get("test.held.thread", 0) + 4
    assert window == {"test.held.thread": 4, "test.held.after": 1}


def test_count_all_adds_each_held_count_once_a_call_and_notes_it():
    with profiling.held() as kept:
        profiling.count("test.replayed.lanes", 20)
        profiling.count("test.replayed.launches")
    before = profiling.counters()
    with profiling.recording():
        t0 = time.perf_counter_ns()
        for _ in range(3):
            profiling.count_all(kept)
        window = profiling.counted(t0)
    after = profiling.counters()
    assert window == {"test.replayed.lanes": 60, "test.replayed.launches": 3}
    assert after["test.replayed.lanes"] == before.get("test.replayed.lanes", 0) + 60
    assert after["test.replayed.launches"] == before.get("test.replayed.launches", 0) + 3


def test_a_running_profiler_turns_spans_on_and_puts_them_in_its_trace():
    from torch.profiler import ProfilerActivity, profile

    with profiling.recording():
        pass  # an empty ring
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("stage", id=4):
            torch.ones(8).add_(1)
    assert [(s.name, s.id) for s in profiling.spans()] == [("stage", 4)]
    host = [e for e in prof.profiler.kineto_results.events() if e.name() == "ssd.stage"]
    assert len(host) == 1
    assert host[0].device_type() == torch.autograd.DeviceType.CPU
    # A function-scope record: the profiler mirrors no user range of it.
    assert [e.scope for e in prof.events() if e.name == "ssd.stage"] == [0]


# ---------------------------------------------------------------------------
# The span trees of the three entry points
# ---------------------------------------------------------------------------


def _tree(spans):
    return {(s.name, s.parent) for s in spans}


def _predictor_tree(tmp_path):
    model, _ = ssd_7(SSDConfig.ssd7(**KW), mode="inference",
                     generator=torch.Generator().manual_seed(0), device="cpu")
    predictor = SSDPredictor(model, batch_size=4)
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (72, 80, 3), np.uint8) for _ in range(5)]
    with profiling.recording():
        predictor.predict(images)
        predictor.predict(images[:2])
        spans, counts = profiling.spans(), profiling.counted()
    calls = [s.id for s in spans if s.name == "predict"]
    assert calls == [1, 2]
    # 5 images take two chunks of 4, 2 images one: 12 slots for 7 images.
    assert counts["predict.requests"] == 2 and counts["predict.images"] == 7
    assert counts["predict.slots"] == 12
    assert "predict.graph_captures" not in counts  # the CPU makes no graph
    stages = ["predict.prepare", "predict.weights_check", "predict.stack", "predict.pin",
              "predict.launch", "predict.read", "predict.finish"]
    expected = {("predict", None)} | {(name, "predict") for name in stages}
    expected |= {(name, "predict.launch") for name in
                 ("decode.compact", "decode.topk", "decode.nms", "decode.global_topk")}
    return spans, expected


def _evaluator_tree(tmp_path):
    files = []
    for i in range(3):
        files.append(str(tmp_path / f"im{i}.jpg"))
        Image.fromarray(np.random.RandomState(i).randint(0, 255, (64, 64, 3), np.uint8)).save(
            files[-1])
    gen = DataGenerator(filenames=files, labels=[np.array([[1, 8, 8, 40, 40]], np.float64)] * 3,
                        image_ids=[str(i) for i in range(3)], load_images_into_memory=True)
    model, _ = ssd_7(SSDConfig.ssd7(**KW), mode="inference",
                     generator=torch.Generator().manual_seed(0), device="cpu")
    ev = Evaluator(model, 3, gen, model_mode="inference", device="cpu")
    with profiling.recording():
        ev(img_height=64, img_width=64, batch_size=2, verbose=False)
        spans, counts = profiling.spans(), profiling.counted()
    assert sorted(s.id for s in spans if s.name == "data.batch") == [0, 1]
    assert sorted(s.id for s in spans if s.name == "eval.drain") == [0, 1]
    assert counts["eval.images"] == 3
    assert counts["eval.detections"] == sum(len(p) for p in ev.prediction_results)
    expected = {("eval.predict", None), ("data.batch", "eval.predict"),
                ("data.read", "data.batch"), ("data.transform", "data.batch"),
                ("data.collate", "data.batch"), ("eval.dispatch", "eval.predict"),
                ("eval.drain", "eval.predict"), ("eval.read", "eval.drain"),
                ("eval.bucket", "eval.drain")}
    expected |= {(name, "eval.dispatch") for name in
                 ("decode.compact", "decode.topk", "decode.nms", "decode.global_topk")}
    expected |= {(name, None) for name in
                 ("eval.num_gt", "eval.match", "eval.precision_recall", "eval.ap", "eval.map")}
    return spans, expected


def _trainer_tree(tmp_path):
    cfg = SSDConfig.ssd7(**KW)
    model, sizes = ssd_7(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    opt = T.sgd_with_momentum(model.parameters(), 1e-4)
    trainer = T.Trainer(model, opt, T.make_train_step(model, opt, SSDLoss(), l2_reg=1e-4))
    aug = DeviceSSDAugmentation(64, 64)
    encoder = SSDInputEncoder(cfg, sizes, max_gt_boxes=4, device="cpu")
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(0, 256, (2, 72, 80, 3)).astype(np.uint8))
    padded, counts = pad_labels([np.array([[1, 10, 10, 50, 40]], np.float32)] * 2, 4)

    def feed():
        for i in range(100):
            x, labels, n = aug(i, images, torch.from_numpy(padded), torch.from_numpy(counts))
            yield x, encoder.encode_padded(labels, n)

    with profiling.recording():
        trainer.fit_generator(feed(), 2, 1, verbose=False)
        spans, noted = profiling.spans(), profiling.counted()
    assert [s.id for s in spans if s.name == "train.step"] == [0, 1]
    assert noted["train.steps"] == 2 and noted["train.images"] == 4
    step = ["train.next_batch", "train.prepare", "train.forward", "train.loss",
            "train.backward", "train.optimizer"]
    expected = {("train.step", None), ("train.epoch_end", None), ("aug", "train.next_batch"),
                ("aug.draw", "aug"), ("aug.apply", "aug"), ("encode", "train.next_batch")}
    expected |= {(name, "train.step") for name in step}
    return spans, expected


@pytest.mark.parametrize("entry", [_predictor_tree, _evaluator_tree, _trainer_tree],
                         ids=["predictor", "evaluator", "trainer"])
def test_entry_point_span_tree(entry, tmp_path):
    spans, expected = entry(tmp_path)
    assert _tree(spans) == expected
    for s in spans:
        assert s.start_ns <= s.end_ns and 0 <= s.child_ns <= s.end_ns - s.start_ns
