"""The benchmark's FLOP and roofline arithmetic against hand counts, torch's
FLOP counter and the bounds PERF.md states for the two kernels."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import harness, weights
from perfbench.counts import flops, roofline
from perfbench.reference import ssd

torch.set_num_threads(2)


def test_conv1_1_by_hand():
    config = harness.load_json("configs", "ssd300_voc")
    # 300 x 300 outputs, 64 filters of 3 x 3 x 3, a multiply and an add each
    assert flops.conv_flops(config)["conv1_1"] == 300 * 300 * 64 * 3 * 3 * 3 * 2


@pytest.mark.parametrize("name, gflops", [("ssd300_voc", 62.75), ("ssd512_voc", 180.42)])
def test_forward_matches_the_stated_figure_and_torchs_counter(name, gflops):
    config = harness.load_json("configs", name)
    assert round(flops.forward_flops(config) / 1e9, 2) == gflops
    params = weights.seeded(config, 0, torch.device("cpu"))
    x = torch.zeros((1, config["img_height"], config["img_width"], 3))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ssd.forward(config, params, x)
    assert counter.get_total_flops() == flops.forward_flops(config)


def test_training_counts_the_backward_twice_but_conv1_1s_input_gradient():
    config = harness.load_json("configs", "ssd300_voc")
    per = flops.conv_flops(config)
    assert flops.train_flops(config) == 3 * sum(per.values()) - per["conv1_1"]


def test_nms_bound_on_the_main_paths_lanes():
    # SSD300 VOC b8: 160 lanes of 400, 15555 valid rows (chip_smoke phase 4)
    valid = np.zeros((160, 400), bool)
    valid.reshape(-1)[:15555] = True
    keep = np.zeros_like(valid)
    keep[:, 0] = valid[:, 0]
    cost = roofline.nms_bound(valid, keep)
    assert cost["bound_by"] == "bytes"
    assert round(cost["seconds"] * 1e6, 3) == 0.113


def test_jpeg_color_bound_of_32_voc_files():
    nbytes = 32 * roofline.jpeg_color_bytes(375, 500)
    assert round(roofline.jpeg_color_seconds(nbytes) * 1e6, 2) == 8.06
