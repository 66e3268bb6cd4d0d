"""SSD-ResNet34 at 1200x1200 (``configs/ssd_r34_1200_coco.json``,
``architectures/ssd_r34.py``) and the two serving cells that came with it:
the configuration's numbers pinned (sha256 of the seed-5 weights and of the
anchors, FLOPs an image, 15,130 anchors), MLPerf's preprocessing equal in
the port's builder and the configuration file, the two new readers on
synthetic runs, and each new cell at tiny traffic (the 1200x1200 one on
the card: its reference alone is 433 GFLOP an image)."""

import importlib
import time
import types

import pytest
import torch

from perfbench import harness, weights
from perfbench.counts import flops
from perfbench.reference import ssd
from perfbench.tests.conftest import tiny_cell
from perfbench.tests.test_perfbench_architectures import _params_sha, _sha

CONFIG = "ssd_r34_1200_coco"
R34_CELL = "ssd_r34_1200_coco.serve_overload"
SINGLE_CELL = "ssd300_voc.serve_single"
PINNED = dict(params="cf395d0783b34060c9cfd7a10bd4b345662f40feb28905cb7e4f8c6c0859513d",
              anchors="b0af6c9d061b482f86c35a89ef3d0c85800fe248737f2a3db34f175d54051343",
              forward_flops=432831863808)


def test_weights_anchors_and_flops_are_the_pinned_ones():
    config = harness.load_json("configs", CONFIG)
    assert _params_sha(weights.seeded(config, 5, torch.device("cpu"))) == PINNED["params"]
    assert _sha(ssd.anchors(config)) == PINNED["anchors"]
    assert len(ssd.anchors(config)) == 15130
    assert flops.forward_flops(config) == PINNED["forward_flops"]
    assert sum(1 for k in ssd.parameters(config) if k.endswith(".running_var")) == 29


def test_the_ports_mlperf_builder_states_the_configurations_constants():
    # The module, which the package's ``ssd_r34`` builder function shadows.
    ssd_r34 = importlib.import_module("ssd_keras_torch.models.ssd_r34")
    config = harness.load_json("configs", CONFIG)
    assert ssd.architecture(config).PORT_BUILDER == \
        "ssd_keras_torch.models.ssd_r34:ssd_r34_mlperf"
    assert list(ssd_r34.MLPERF_MEAN) == config["subtract_mean"]
    assert list(ssd_r34.MLPERF_STD) == config["divide_by_stddev"]
    assert config["swap_channels"] is None
    assert ssd_r34.BN_EPS == ssd.architecture(config).BN_EPS


def _traced(kernel_s, busy_s):
    return types.SimpleNamespace(traced=dict(kernel_s=kernel_s, busy_s=busy_s))


def test_conv_busy_reads_the_convolution_kernels_over_busy_time():
    read = harness.load_module("metrics", "serve.conv_busy_pct").read
    kernels = {"sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": 0.3,
               "void_cutlass__5x_cudnn::Kernel_cutlass_tensorop_bf16_s16816fprop": 0.1,
               "cudnn::ops::conv2d_grouped_direct_kernel": 0.1,
               "void_at::native::elementwise_kernel_128__4__at::native::gpu_kern": 0.2,
               "convert_bf16_to_f32_kernel": 0.2, "ssd_greedy_nms_pass_a": 0.1}
    assert read(_traced(kernels, 1.0)) == pytest.approx(50.0)
    assert read(types.SimpleNamespace(traced=None)) is None


def test_lanes_per_slot_reads_the_programs_counters(monkeypatch):
    from perfbench import program

    read = harness.load_module("metrics", "serve.nms_lanes_per_slot").read
    monkeypatch.setattr(program, "counts", lambda run: {"decode.lanes": 640 * 5,
                                                        "predict.slots": 8 * 5})
    assert read(None) == 80
    monkeypatch.setattr(program, "counts", lambda run: {"predict.slots": 40})
    assert read(None) is None  # a program that counts no lanes


def test_the_batch_one_cell_runs_at_tiny_traffic(tiny_run):
    run = tiny_run(SINGLE_CELL, seed=3000000123)
    assert run.correct and run.failed == 0 and run.attempted > 0
    assert run.values["images"] == run.values["requests"]  # one image a request, all served
    assert {"served_img_per_s", "request_p95_ms"} <= set(run.e2e)


@pytest.mark.cuda
def test_the_r34_cell_runs_at_tiny_traffic_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = tiny_cell(R34_CELL)
    args = types.SimpleNamespace(seed=3000000124, seconds=2.0, trace=0, device="cuda")
    run = harness.Run(args, R34_CELL, cell, harness.load_json("configs", cell["config"]),
                      time.perf_counter())
    harness.load_module("drivers", cell["driver"]).run(run)
    assert run.correct and run.failed == 0 and run.attempted > 0, run.checks
    assert run.e2e["served_img_per_s"] > 0
