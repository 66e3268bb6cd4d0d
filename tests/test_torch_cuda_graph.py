"""The port's one CUDA-graph capture (``utils/cuda_graph.py``) and its one
counter mechanism (``utils/profiling.py``), on the CPU.

The capture helper's bookkeeping runs here with the graph calls stood in
for (the CPU has no CUDA graph): warm-up calls count as eager calls, the
capture's counts are held, and each call copies its input in and counts
them again. Then the layering that keeps the two modules general: neither
imports a kernel, the native code, a model or the predictor; the package
has one ``torch.cuda.graph(`` site and no module-level launch counter.
"""

import ast
import contextlib
from pathlib import Path

import pytest
import torch

from ssd_keras_torch.utils import cuda_graph, profiling

PACKAGE = Path(__file__).resolve().parent.parent / "ssd_keras_torch"


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def no_card_graph(monkeypatch):
    """``torch.cuda``'s stream and graph calls as no-ops: the captured call
    runs once, eagerly, and a replay does nothing."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, stream=None: contextlib.nullcontext())


def test_a_capture_holds_its_counts_and_each_call_counts_them_again(no_card_graph):
    calls = []

    def fn(x):
        calls.append(torch.is_inference_mode_enabled())
        profiling.count("test.graph.launches", 2)
        profiling.count("test.graph.lanes", 5)
        return x * 2

    def keep_alive():
        kept.append(len(calls))
        return [weight]

    weight, kept = torch.ones(3), []
    before = profiling.counters()
    graph = cuda_graph.CapturedGraph(fn, torch.zeros(4), _Stream(), keep_alive)
    made = profiling.counters()
    assert calls == [True] * (cuda_graph.WARMUP_CALLS + 1)
    assert graph.counts == {"test.graph.launches": 2, "test.graph.lanes": 5}
    assert kept == [cuda_graph.WARMUP_CALLS + 1] and graph.keep_alive == [weight]
    # The warm-up counts as eager calls do; the capture counts nothing.
    assert made["test.graph.launches"] == (before.get("test.graph.launches", 0)
                                           + 2 * cuda_graph.WARMUP_CALLS)

    x = torch.arange(4.0)
    out = [graph(x), graph()]
    after = profiling.counters()
    assert graph.graph.replays == 2 and torch.equal(graph.static_in, x)
    assert all(o is not graph.static_out for o in out)
    assert after["test.graph.launches"] == made["test.graph.launches"] + 4
    assert after["test.graph.lanes"] == made["test.graph.lanes"] + 10


def _imports(path: Path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names += [node.module or ""] + [f"{node.module}.{alias.name}" for alias in node.names]
    return names


@pytest.mark.parametrize("module", ["utils/profiling.py", "utils/cuda_graph.py"])
def test_the_counters_and_the_capture_import_no_kernel_native_model_or_predictor(module):
    banned = ("kernels", "native", "models", "predictor")
    found = [name for name in _imports(PACKAGE / module)
             if name.startswith("ssd_keras_torch.")
             and name.split(".")[1] in banned]
    assert found == []


def test_the_package_has_one_graph_capture_and_no_module_counter():
    sources = {path: path.read_text() for path in PACKAGE.rglob("*.py")}
    sites = [path.relative_to(PACKAGE).as_posix() for path, text in sources.items()
             for _ in range(text.count("torch.cuda.graph("))]
    assert sites == ["utils/cuda_graph.py"]
    defined = []
    for path, text in sources.items():
        for node in ast.parse(text).body:
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(node, (ast.AnnAssign, ast.AugAssign))
                       else [])
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if isinstance(node, ast.FunctionDef):
                names.append(node.name)
            defined += [f"{path.relative_to(PACKAGE).as_posix()}:{name}" for name in names
                        if name in ("launches", "captured", "captured_lanes", "replayed")]
    assert defined == []
