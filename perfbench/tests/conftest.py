"""A cell run at a tiny size on the CPU: the harness's look for a card is
skipped, everything else of a run is driven (``tiny_run``)."""

import time
import types

import pytest
import torch

from perfbench import harness

# Shrunk traffic, so that the CPU runs a cell in seconds.
TINY = {
    "ssd300_voc.serve_open": dict(traffic=dict(rate_per_s=2.0, images_per_request=[1, 3],
                                               pool_per_shape=2), check=dict(requests=3)),
    "ssd300_voc.serve_overload": dict(traffic=dict(rate_per_s=40.0, images_per_request=[1, 3],
                                                   pool_per_shape=2), check=dict(requests=3)),
    "ssd512_voc.eval_voc07": dict(traffic=dict(images=16, warmup_images=8),
                                  check=dict(images=8), jpeg_device="cpu"),
    "ssd300_voc.train_device_aug": dict(traffic=dict(images=16, steps_per_epoch=1), batch_size=8),
}


def tiny_cell(name: str) -> dict:
    cell = harness.load_json("cells", name)
    for key, value in TINY[name].items():
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
