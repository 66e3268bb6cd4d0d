"""The control of each cell's check comes out not correct: the plain
reference computed in float8 (e4m3) in the program's place fails at least
one of the cell's limits. At a tiny size on the CPU, and at the cell's own
size on the card."""

import time
import types

import pytest
import torch

from perfbench import harness

CELLS = ["ssd300_voc.serve_overload", "ssd512_voc.eval_voc07", "ssd300_voc.train_device_aug"]


def _control(cell: dict, name: str, seed: int, seconds: float, device: str) -> dict:
    config = harness.load_json("configs", cell["config"])
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0, device=device)
    run = harness.Run(args, name, cell, config, time.perf_counter())
    return harness.load_module("drivers", cell["driver"]).control(run, torch.float8_e4m3fn)


def _fails(cell: dict, readings: dict) -> bool:
    return any(readings[k] > limit for k, limit in cell["check"]["limits"].items())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_a_tiny_size(name):
    from conftest import tiny_cell

    torch.set_num_threads(4)
    cell = tiny_cell(name)
    readings = _control(cell, name, 3000000101, 1.5, "cpu")
    assert _fails(cell, readings), readings


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_fails_at_the_cells_size_on_the_card(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.load_json("cells", name)
    readings = _control(cell, name, seed, harness.manifest()["run_seconds"], "cuda")
    assert _fails(cell, readings), readings
