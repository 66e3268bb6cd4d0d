"""A cell run at a tiny size on the CPU: the harness's look for a card is
skipped, everything else of a run is driven (``tiny_run``)."""

import json
import time
import types

import pytest
import torch

from perfbench import harness


def tiny_cell(name: str) -> dict:
    """The cell's file with the shrunk traffic of ``tests/tiny/<cell>.json``
    (so that the CPU runs the cell in seconds) merged in: a dict into the
    cell's dict of that key, anything else in place of the cell's value."""
    cell = harness.load_json("cells", name)
    with open(harness.ROOT / "tests" / "tiny" / f"{name}.json") as f:
        tiny = json.load(f)
    for key, value in tiny.items():
        if isinstance(value, dict):
            cell[key] = dict(cell[key], **value)
        else:
            cell[key] = value
    return cell


@pytest.fixture
def tiny_run():
    def go(name: str, seed: int, seconds: float = 1.5) -> harness.Run:
        torch.set_num_threads(4)
        cell = tiny_cell(name)
        args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0, device="cpu")
        run = harness.Run(args, name, cell, harness.load_json("configs", cell["config"]),
                          time.perf_counter())
        harness.load_module("drivers", cell["driver"]).run(run)
        return run
    return go
