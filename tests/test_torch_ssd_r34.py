"""SSD-ResNet34 (``models/ssd_r34.py``) against the benchmark's plain
reference (``perfbench/architectures/ssd_r34.py``), on the CPU.

The shapes are checked at the published 1200x1200 without a forward; the
forwards run at 400x400, the smallest side a third of 1200 whose extra
layers all have a map (heads 17, 9, 5, 3, 1, 1), with the benchmark's
seeded weights and per-channel random BatchNorm statistics. Also here:
BatchNorm folding, the strided fused heads, SSD300's heads as they were,
and the decode at 80 classes against the reference decode."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench import harness, port, traffic, weights
from perfbench.reference import decode as ref_decode
from perfbench.reference import ssd as ref_ssd
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.decoder import decode_detections_fixed, decode_offsets
from ssd_keras_torch.models import ssd_300, ssd_r34, ssd_r34_predictor_sizes
from ssd_keras_torch.models.layers import fuse_head_params, fused_prediction_heads
from ssd_keras_torch.models.ssd_r34 import MLPERF_MEAN, MLPERF_STD, SSDR34, ssd_r34_config
from ssd_keras_torch.utils import profiling

CONFIG = "ssd_r34_1200_coco"
# Class scores after the softmax (0-1) and box offsets (~0.3 RMS) of the
# float32 port against the float32 reference: the same arithmetic but for
# the order of each convolution's sums (oneDNN's blocking, and the
# BatchNorm's scale taken into the kernel), over 36 layers. Measured
# 2.8e-7 and 2.9e-6; bf16 convolutions miss them by 1.2e-3 and 1.0e-2.
SCORE_ATOL = 1e-5
OFFSET_ATOL = 5e-5
# Folded against unfolded BatchNorm, both float32: the fold rounds its
# kernel once (float64 to float32) where the layer rounds its product.
# Measured 2.6e-6.
FOLD_ATOL = 2e-5


def _config(size=400, **overrides):
    return dict(harness.load_json("configs", CONFIG), img_height=size, img_width=size,
                **overrides)


def _params(config, seed=5):
    """The benchmark's seeded weights with per-channel random BatchNorm
    statistics and affine maps in place of its constants, drawn around
    them so that the scores stay unsaturated (0.1% clear 0.05)."""
    params = weights.seeded(config, seed, torch.device("cpu"))
    gen = torch.Generator().manual_seed(seed)
    for bn in sorted(k[:-len(".running_mean")] for k in params if k.endswith(".running_mean")):
        n = params[f"{bn}.weight"].shape
        params[f"{bn}.weight"] = torch.rand(n, generator=gen) * 0.4 + 0.7
        params[f"{bn}.bias"] = torch.randn(n, generator=gen) * 0.1
        params[f"{bn}.running_mean"] = torch.randn(n, generator=gen) * 0.2
        params[f"{bn}.running_var"] = torch.rand(n, generator=gen) * 1.5 + 1.0
    return params


def _images(config, n=2, seed=1):
    """The benchmark's seeded images (``perfbench.traffic``) at the model's size."""
    shape = [config["img_height"], config["img_width"]]
    pool = traffic.image_pool(dict(shapes=[shape], pool_per_shape=n), seed, torch.device("cpu"))
    return torch.from_numpy(pool[0]).float()


def _port_predictions(config, params, images, fold_bn=True):
    model = port.model(config, "inference", params, torch.device("cpu"))
    model.fold_bn = fold_bn
    with torch.no_grad():
        return model.predictions(images)


@pytest.fixture(scope="module")
def reference():
    torch.manual_seed(0)
    config = _config()
    params = _params(config)
    images = _images(config)
    with torch.no_grad():
        scores, offsets = ref_ssd.forward(config, params, images)
    return config, params, images, scores, offsets


def test_shapes_at_1200_sources_heads_and_anchors():
    config = harness.load_json("configs", CONFIG)
    sizes = ref_ssd.feature_sizes(config)
    assert [sizes[f"source{i}"] for i in range(6)] == [(150, 150), (75, 75), (38, 38),
                                                       (19, 19), (9, 9), (7, 7)]
    grids = [(50, 50), (25, 25), (13, 13), (7, 7), (3, 3), (3, 3)]
    assert ssd_r34_predictor_sizes(1200, 1200) == grids
    assert ref_ssd.predictor_sizes(config) == grids
    cfg = port.ssd_config(config)
    assert cfg.total_boxes(grids) == 15130 == len(ref_ssd.anchors(config))
    model = SSDR34(cfg, mode="inference")
    assert model.anchors8.shape == (15130, 8)
    np.testing.assert_allclose(model.anchors8, ref_ssd.anchors(config), rtol=0, atol=1e-12)
    assert all(getattr(model, f"{h}{i}").stride == (3, 3) for h in ("conf", "loc")
               for i in range(6))
    assert len(model.bn_pairs) == 29
    assert set(model.state_dict()) == set(ref_ssd.parameter_shapes(config))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        ref_ssd.parameter_shapes(config)
    for key in ("layer3.0.downsample.0.weight", "bn1.running_var", "layer2.0.downsample.1.bias",
                "additional_blocks.4.2.weight", "conf5.weight", "loc0.bias"):
        assert key in model.state_dict()


def test_the_port_matches_the_reference_in_float32(reference):
    config, params, images, scores, offsets = reference
    got = _port_predictions(dict(config, compute_dtype="float32"), params, images)
    assert got.shape == (2, 17 * 17 * 4 + 9 * 9 * 6 + 5 * 5 * 6 + 3 * 3 * 6 + 4 + 4, 93)
    assert (got[..., :81] - scores).abs().max() <= SCORE_ATOL
    assert (got[..., 81:85] - offsets).abs().max() <= OFFSET_ATOL
    anchors = torch.from_numpy(ref_ssd.anchors(config)).float()
    assert torch.equal(got[0, :, 85:], anchors)


def test_the_tolerances_see_bfloat16(reference):
    config, params, images, scores, offsets = reference
    got = _port_predictions(dict(config, compute_dtype="bfloat16"), params, images)
    assert (got[..., :81] - scores).abs().max() > SCORE_ATOL
    assert (got[..., 81:85] - offsets).abs().max() > OFFSET_ATOL


def test_folded_equals_unfolded_and_folds_once_per_weights(reference):
    config, params, images, _, _ = reference
    config = dict(config, compute_dtype="float32")
    model = port.model(config, "inference", params, torch.device("cpu"))
    before = profiling.counters().get("model.bn_folded", 0)
    with torch.no_grad():
        folded = model.predictions(images)
        again = model.predictions(images)
        model.fold_bn = False
        unfolded = model.predictions(images)
        model.fold_bn = True
    assert profiling.counters()["model.bn_folded"] == before + 29
    assert torch.equal(folded, again)
    assert (folded - unfolded).abs().max() <= FOLD_ATOL
    # New weights fold again: the served forward follows load_state_dict.
    other = _params(config, seed=6)
    model.load_state_dict(other)
    with torch.no_grad():
        reloaded = model.predictions(images)
        model.fold_bn = False
        want = model.predictions(images)
    assert profiling.counters()["model.bn_folded"] == before + 58
    assert (reloaded - want).abs().max() <= FOLD_ATOL
    assert (reloaded - folded).abs().max() > 100 * FOLD_ATOL


def test_the_served_forward_runs_no_batchnorm(reference, monkeypatch):
    config, params, images, _, _ = reference
    model = port.model(config, "inference", params, torch.device("cpu"))

    def refuse(self, x):
        raise AssertionError("a BatchNorm ran")

    monkeypatch.setattr(type(model.bn1), "forward", refuse)
    with torch.no_grad():
        out = model(images[:1])
    assert out.shape == (1, 200, 6)


def test_strided_fused_heads_equal_two_strided_convolutions():
    gen = torch.Generator().manual_seed(2)
    feat = torch.randn(2, 16, 19, 19, generator=gen)
    cw, lw = torch.randn(4 * 81, 16, 3, 3, generator=gen), torch.randn(16, 16, 3, 3, generator=gen)
    cb, lb = torch.randn(4 * 81, generator=gen), torch.randn(16, generator=gen)
    weight, bias = fuse_head_params(cw, lw, cb, lb, torch.float32)
    conf, loc = fused_prediction_heads(feat, weight, bias, 4 * 81, stride=3, padding=1)
    want_conf = F.conv2d(feat, cw, cb, 3, 1).permute(0, 2, 3, 1)
    want_loc = F.conv2d(feat, lw, lb, 3, 1).permute(0, 2, 3, 1)
    assert conf.shape == (2, 7, 7, 324) and loc.shape == (2, 7, 7, 16)
    torch.testing.assert_close(conf, want_conf, rtol=0, atol=1e-4)
    torch.testing.assert_close(loc, want_loc, rtol=0, atol=1e-4)


def test_ssd300_heads_are_the_same_single_convolution(monkeypatch):
    """Stride 1, padding 1 and one conv call a head pair, as before."""
    model, _ = ssd_300(SSDConfig.ssd300(), mode="training", device="cpu",
                       generator=torch.Generator().manual_seed(0))
    calls = []
    real = F.conv2d

    def spy(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        calls.append((tuple(w.shape), stride, padding))
        return real(x, w, b, stride, padding, dilation, groups)

    monkeypatch.setattr(F, "conv2d", spy)
    feat = torch.randn(1, 256, 3, 3)
    with torch.no_grad():
        conf, loc = model.heads(feat, "conv8_2_mbox_conf", "conv8_2_mbox_loc")
        w = torch.cat([model.conv8_2_mbox_conf.weight, model.conv8_2_mbox_loc.weight])
        b = torch.cat([model.conv8_2_mbox_conf.bias, model.conv8_2_mbox_loc.bias])
        want = real(feat, w, b, padding=1).permute(0, 2, 3, 1)
    assert calls == [((4 * 21 + 16, 256, 3, 3), (1, 1), (1, 1))]
    assert torch.equal(torch.cat([conf, loc], -1), want)


def _seeded_predictions(config, n_images=2, seed=3):
    """Softmax scores over 81 classes and offsets on the anchors of
    ``config``: a (B, N, 93) prediction tensor."""
    gen = torch.Generator().manual_seed(seed)
    anchors = torch.from_numpy(ref_ssd.anchors(config)).float()
    n = len(anchors)
    logits = torch.randn(n_images, n, 81, generator=gen) * 1.5
    offsets = torch.randn(n_images, n, 4, generator=gen) * 0.4
    scores = torch.softmax(logits, -1)
    return torch.cat([scores, offsets, anchors.expand(n_images, -1, -1)], -1)


def test_the_decode_at_80_classes_equals_the_reference_decode():
    config = _config()
    y_pred = _seeded_predictions(config)
    corners = decode_offsets(y_pred, img_height=400, img_width=400)
    want = ref_decode.decode(y_pred[..., :81], corners, 0.05, 0.5, 200, 200)
    before = profiling.counters().get("decode.lanes", 0)
    got = decode_detections_fixed(y_pred, confidence_thresh=0.05, iou_threshold=0.5,
                                  top_k=200, nms_max_output_size=200, img_height=400,
                                  img_width=400)
    assert profiling.counters()["decode.lanes"] == before + 2 * 80
    assert (want["detections"][..., 0] != 0).sum() > 100
    assert torch.equal(got, want["detections"])


def test_only_inference_modes_build_and_the_graph_does_not_train():
    cfg = ssd_r34_config(img_height=400, img_width=400)
    with pytest.raises(ValueError, match="BatchNorm training"):
        ssd_r34(cfg, mode="training", device="cpu")
    model, sizes = ssd_r34(cfg, mode="inference_fast", device="cpu")
    assert sizes.tolist() == [[17, 17], [9, 9], [5, 5], [3, 3], [1, 1], [1, 1]]
    assert not model.training
    with pytest.raises(ValueError, match="inference-only"):
        model.train()
    with pytest.raises(ValueError, match="too small"):
        ssd_r34_predictor_sizes(384, 400)


def test_the_mlperf_builder_sets_mlperf_preprocessing():
    where, name = ref_ssd.architecture(_config()).PORT_BUILDER.split(":")
    assert (where, name) == ("ssd_keras_torch.models.ssd_r34", "ssd_r34_mlperf")
    plain = SSDConfig.ssd300(n_classes=80)  # a config with a mean and a channel swap
    from ssd_keras_torch.models.ssd_r34 import ssd_r34_mlperf

    model, _ = ssd_r34_mlperf(ssd_r34_config(img_height=400, img_width=400,
                                             subtract_mean=plain.subtract_mean,
                                             swap_channels=plain.swap_channels),
                              compute_dtype=torch.float32, device="cpu")
    assert model.config.subtract_mean == MLPERF_MEAN
    assert model.config.divide_by_stddev == MLPERF_STD
    assert model.config.swap_channels is None
