"""``ssd_keras_torch.utils.profiling`` against the JAX package's
``utils/profiling.py``: ``benchmark_fps`` returns the JAX function's keys
with consistent values, ``trace`` writes a Chrome trace, and
``device_sync`` takes CPU tensors and no argument without waiting for
anything. The CUDA-event timers run only on the card (``chip_smoke.py``)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_keras_tpu.utils import profiling as jax_profiling
from ssd_keras_torch.utils import profiling

torch.set_num_threads(2)


def test_benchmark_fps_returns_the_jax_keys():
    batch = np.random.RandomState(0).rand(4, 8, 8, 3).astype(np.float32)
    want = jax_profiling.benchmark_fps(lambda x: jnp.tanh(x), batch, n_iters=3, n_repeats=2,
                                       warmup=1)
    got = profiling.benchmark_fps(torch.tanh, batch, n_iters=3, n_repeats=2, warmup=1)
    assert set(got) == set(want)
    assert got["batch_size"] == want["batch_size"] == 4
    assert got["n_iters"] == 3 and len(got["times_s"]) == 2
    best = min(got["times_s"])
    assert got["fps"] == pytest.approx(4 * 3 / best)
    assert got["ms_per_batch"] == pytest.approx(best / 3 * 1000.0)


def test_benchmark_fps_takes_a_batch_size_and_runs_without_grad():
    calls = []

    def forward(x):
        calls.append(torch.is_grad_enabled())
        return x * 2

    out = profiling.benchmark_fps(forward, torch.ones(2, 3), n_iters=2, n_repeats=2, warmup=1,
                                  batch_size=16)
    assert out["batch_size"] == 16 and out["fps"] > 0
    assert len(calls) == 1 + 2 * 2 and not any(calls)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        torch.relu(torch.randn(64, 64)) @ torch.randn(64, 64)
    files = list((tmp_path / "trace").glob("*.json"))
    assert log_dir == str(tmp_path / "trace") and len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_trace_writes_its_file_when_the_body_raises(tmp_path):
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path)):
            torch.ones(3).sum()
            raise ValueError("body failed")
    assert len(list(tmp_path.glob("*.json"))) == 1


def test_device_sync_needs_no_card_for_cpu_tensors():
    profiling.device_sync(torch.ones(2))
    profiling.device_sync()


def test_summary_of_repeats():
    s = profiling.summary([2.0, 1.0, 4.0])
    assert (s["median"], s["min"], s["max"]) == (2.0, 1.0, 4.0)
    assert s["spread_pct"] == pytest.approx(150.0) and s["runs"] == [2.0, 1.0, 4.0]


def test_time_calls_on_the_cpu_names_its_timer():
    calls = []
    out = profiling.time_calls(lambda: calls.append(1), "cpu", iters=4, repeats=3, warmup=2)
    assert len(calls) == 2 + 3 * 4
    assert out["iters"] == 4 and len(out["runs"]) == 3 and out["hold_ms"] is None
    assert out["timer"] == "host clock (cpu)"
    assert {"median", "min", "max", "spread_pct"} <= set(out)


def test_card_line_of_the_cpu():
    from ssd_keras_torch.examples.common import card_line

    assert card_line("cpu") == "cpu"
