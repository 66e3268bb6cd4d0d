"""The port on a CUDA card: the NMS kernel and its IoU-mask pass against
their plain versions (also from a scratch of all ones, and with the
scratch kept per stream), the training slice
(encode, train step, BatchNorm) against the CPU, and the data-parallel path
(augmentation against the CPU, the streamed upload against the direct path,
a one-rank NCCL step against the plain step, the dry run on two gloo ranks
sharing the card), and the evaluation path (SSD512 against the CPU, the
evaluator on the card against the CPU, the COCO tools' lanes, the host C++
built with g++), the predictor on gray and RGBA frames (no PIL) and through
its per-shape CUDA graphs (equal to the eager path, NMS launches and
decode lanes counted on replay, dropped on a weight reload, a scratch of
each graph's own; SSD-ResNet34's, its BatchNorms folded once), the
host-chain Trainer, the JPEG batch decoder (nvJPEG and the colour
kernel against PIL and the kernel's plain version, on nvJPEG's planes and
on ``chip_smoke.JPEG_COLOR_CASES``' edge cases, errors with the file's
index, calls from several threads, ``DataGenerator``'s batch path), and
the resize kernel against its plain version and the evaluator's card path
against the host chain (batches, results, back-to-back decodes), and the
convolutions' epilogue kernel against its plain version and PyTorch's ops
(``chip_smoke.EPILOGUE_CASES``), its pooled variant against its plain
version and PyTorch's ops then ``max_pool2d`` (``chip_smoke.POOL_CASES``),
both counted in the predictor's graphs (29 an SSD300 forward, 4 of them
pooled; 45 an SSD-ResNet34 one, 1 pooled) and in the entry's captured
forward (29, 4 pooled), and giving the detections of the grad-enabled
forward.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so it also runs on a machine with
a card and no JAX (``tests/conftest.py`` imports JAX, hence the flag):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import (EPILOGUE_CASES, JPEG_COLOR_CASES, POOL_CASES, EagerPredictor,
                        StreamModel, epilogue_inputs, library_epilogue, library_pool,
                        noisy_oracle, pool_inputs, random_lanes, same_bits, seeded_state)
from test_torch_resize import RESIZE_CASES
from ssd_keras_torch import SSDConfig, SSDInputEncoder, SSDLoss, SSDPredictor, ssd_7, ssd_300
from ssd_keras_torch import train as T
from ssd_keras_torch.data import SynthVOC
from ssd_keras_torch.data.device_aug import DeviceSSDAugmentation, batch_seed
from ssd_keras_torch.data.streaming import StreamingDeviceInput
from ssd_keras_torch.decoder import decode_detections_fast_fixed, decode_detections_fixed
from ssd_keras_torch.encoder import pad_labels
from ssd_keras_torch.kernels import nms as nms_kernel
from ssd_keras_torch.models import BatchNorm, ssd7_predictor_sizes, ssd300_predictor_sizes
from ssd_keras_torch.ops.nms import greedy_nms_mask, iou_suppression_mask, words_read
from ssd_keras_torch.parallel import sharding as sh
from ssd_keras_torch.parallel.dryrun import dryrun_multichip
from ssd_keras_torch.utils import profiling
from ssd_keras_torch.utils.cuda_graph import WARMUP_CALLS, CapturedGraph

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


def _count(name):
    """The program counter ``name`` (0 before its first count)."""
    return profiling.counters().get(name, 0)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lanes(seed, lanes, k, kind):
    """``chip_smoke.random_lanes`` from ``seed``: the lanes phase 3 of the
    smoke run checks the kernel on."""
    return random_lanes(np.random.RandomState(seed), lanes, k, kind)


_KERNEL_CASES = [
    (160, 400, "prefix", 0.0), (640, 400, "random", 1.0), (8, 400, "prefix", -1.0),
    (3, 37, "random", 0.0), (2, 3000, "prefix", 0.0),  # 47 words a row, 1128 tiles a lane
    (16, 64, "random", 1.0), (16, 65, "prefix", 0.0),  # one word, and one bit past it
    (160, 400, "sparse", 0.0), (24, 400, "hard", 0.0), (24, 65, "hard", -1.0),
]


@pytest.mark.parametrize("lanes, k, kind, d", _KERNEL_CASES)
def test_kernel_equals_plain(cuda, lanes, k, kind, d):
    boxes, valid = _lanes(0, lanes, k, kind)
    b, v = torch.from_numpy(boxes).to(cuda), torch.from_numpy(valid).to(cuda)
    before = _count("nms.launches")
    got = nms_kernel.greedy_nms_mask_batched(b, v, 0.45, d)
    torch.cuda.synchronize()
    assert _count("nms.launches") == before + 1
    assert torch.equal(got, greedy_nms_mask(b, v, 0.45, d))
    assert torch.equal(got.cpu(), greedy_nms_mask(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45, d))


@pytest.mark.parametrize("lanes, k, kind, d", _KERNEL_CASES)
def test_iou_mask_equals_plain_on_the_words_pass_b_reads(cuda, lanes, k, kind, d):
    boxes, valid = _lanes(1, lanes, k, kind)
    b, v = torch.from_numpy(boxes).to(cuda), torch.from_numpy(valid).to(cuda)
    before = _count("nms.launches")
    got = nms_kernel.iou_mask(b, v, 0.45, d)
    torch.cuda.synchronize()
    assert _count("nms.launches") == before  # not a launch of the main path
    read = words_read(v)
    assert torch.equal(got[read], iou_suppression_mask(b, v, 0.45, d)[read])


def test_kernel_reads_no_unwritten_scratch_word(cuda, monkeypatch):
    """Pass B reads only the words pass A writes: a scratch that holds all
    ones before each call gives the same keep mask."""
    scratch = nms_kernel._scratch
    monkeypatch.setattr(nms_kernel, "_scratch", lambda *a: scratch(*a).fill_(-1))
    for lanes, k, kind, d in [(160, 400, "random", 0.0), (24, 65, "hard", 1.0),
                              (160, 400, "sparse", 0.0)]:
        boxes, valid = _lanes(2, lanes, k, kind)
        b, v = torch.from_numpy(boxes).to(cuda), torch.from_numpy(valid).to(cuda)
        assert torch.equal(nms_kernel.greedy_nms_mask_batched(b, v, 0.45, d),
                           greedy_nms_mask(b, v, 0.45, d))


def test_scratch_is_kept_per_stream(cuda):
    """Calls on one stream reuse its scratch, grown to the largest call; a
    call on another stream gets its own. Each call's keep mask still equals
    the plain version after a larger call left its words in the scratch."""
    shapes = [(8, 400, "prefix"), (160, 400, "random"), (8, 400, "hard")]
    lanes = [tuple(torch.from_numpy(a).to(cuda) for a in _lanes(3, *s)) for s in shapes]
    index = cuda.index if cuda.index is not None else torch.cuda.current_device()

    def scratch_ptr():
        return nms_kernel._scratches[index, nms_kernel.raw_stream(index)].data_ptr()

    ptrs = []
    for b, v in lanes:
        assert torch.equal(nms_kernel.greedy_nms_mask_batched(b, v), greedy_nms_mask(b, v, 0.45))
        ptrs.append(scratch_ptr())
    assert ptrs[1] == ptrs[2]  # the L = 160 scratch serves the smaller call after it
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        b, v = lanes[1]
        keep = nms_kernel.greedy_nms_mask_batched(b, v)
        assert scratch_ptr() != ptrs[2]
    torch.cuda.current_stream(cuda).wait_stream(side)
    assert torch.equal(keep, greedy_nms_mask(b, v, 0.45))


def test_kernel_on_empty_lanes_launches_nothing(cuda):
    keep = nms_kernel.greedy_nms_mask_batched(
        torch.zeros(0, 400, 4, device=cuda), torch.zeros(0, 400, dtype=torch.bool, device=cuda))
    assert keep.shape == (0, 400)


def _y_pred(n_classes, batch=2, seed=0):
    cfg = SSDConfig.ssd300(n_classes=n_classes, dataset="coco" if n_classes == 80 else "voc")
    anchors = cfg.anchor_tensor(ssd300_predictor_sizes(300, 300)).astype(np.float32)
    rng = np.random.RandomState(seed)
    logits = rng.randn(batch, anchors.shape[0], n_classes + 1).astype(np.float32) * 2.5
    e = np.exp(logits - logits.max(-1, keepdims=True))
    confs = e / e.sum(-1, keepdims=True)
    offsets = rng.randn(batch, anchors.shape[0], 4).astype(np.float32) * 0.5
    return torch.from_numpy(np.concatenate(
        [confs, offsets, np.broadcast_to(anchors, (batch, anchors.shape[0], 8))], axis=-1
    ).astype(np.float32))


@pytest.mark.parametrize("n_classes, fast", [(20, False), (80, False), (20, True)])
def test_decoder_on_card_equals_cpu(cuda, n_classes, fast):
    """One y_pred decoded on the card (the kernel) and on the CPU (the plain
    version): the same rows, scores equal, boxes within 1e-3 px (the two
    devices' ``exp`` may differ in the last ulp)."""
    y_pred = _y_pred(n_classes)
    decode = decode_detections_fast_fixed if fast else decode_detections_fixed
    kw = dict(confidence_thresh=0.3 if fast else 0.01, img_height=300, img_width=300)
    got = decode(y_pred.to(cuda), **kw).cpu()
    expected = decode(y_pred, **kw)
    assert torch.equal(got[..., :2], expected[..., :2])
    torch.testing.assert_close(got[..., 2:], expected[..., 2:], rtol=0, atol=1e-3)


def _served_model(cuda, seed=0):
    """SSD300 VOC 'inference' in bf16 from a seeded init, conv1_1 x 1/100."""
    model, _ = ssd_300(SSDConfig.ssd300(), mode="inference", compute_dtype=torch.bfloat16,
                       device=cuda, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.conv1_1.weight.mul_(0.01)
    return model


def test_predictor_serves_on_card(cuda):
    model = _served_model(cuda)
    frames = [np.random.RandomState(i).randint(0, 256, (480, 640, 3), dtype=np.uint8)
              for i in range(3)]
    before = _count("nms.launches")
    out = SSDPredictor(model, batch_size=2).predict(frames)
    # Two chunks, one launch each, after the eager warm-up before the capture.
    assert _count("nms.launches") == before + WARMUP_CALLS + 2
    assert len(out) == 3
    for dets in out:
        assert dets.shape[1] == 6 and len(dets) > 0 and np.isfinite(dets).all()


def _frames(seed):
    rng = np.random.RandomState(seed)
    return ([rng.randint(0, 256, (300, 300, 3), dtype=np.uint8) for _ in range(3)]
            + [rng.randint(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(3)])


def test_graph_cache_equals_eager_on_card(cuda):
    """Two shapes, two chunks each (one padded), through the CUDA graphs and
    through the eager path: the same detections bit for bit (the same
    kernels on the same inputs, replayed)."""
    model = _served_model(cuda)
    cached = SSDPredictor(model, batch_size=2)
    frames = _frames(1)
    for _ in range(2):  # the capture's call, then replays only
        got = cached.predict(frames)
        for dets, ref in zip(got, EagerPredictor(model, batch_size=2).predict(frames)):
            assert len(dets) > 0
            np.testing.assert_array_equal(dets, ref)
    assert list(cached._compiled) == [(300, 300, "|u1"), (480, 640, "|u1")]
    assert all(isinstance(run, CapturedGraph) for run in cached._compiled.values())


def test_graph_replays_count_nms_launches(cuda):
    """A capture records the NMS wrapper's call and holds its count; each
    replay counts the calls its graph holds."""
    model = _served_model(cuda)
    predictor = SSDPredictor(model, batch_size=2)
    frames = _frames(2)
    before = _count("nms.launches")
    predictor.predict(frames)
    assert _count("nms.launches") == before + 2 * WARMUP_CALLS + 4
    # One call in each shape's graph.
    assert [run.counts["nms.launches"] for run in predictor._compiled.values()] == [1, 1]
    before = _count("nms.launches")
    predictor.predict(frames)
    assert _count("nms.launches") == before + 4


def test_graph_replays_count_decode_lanes(cuda):
    """An eager decode counts its lanes in ``decode.lanes``; a capture
    holds them, and each replay counts the lanes its graph holds."""
    predictor = SSDPredictor(_served_model(cuda), batch_size=2)
    frames = _frames(2)
    before = profiling.counters().get("decode.lanes", 0)
    predictor.predict(frames)
    # Two shapes: one eager warm-up each, then two replays each, 2 x 20 lanes a call.
    assert profiling.counters()["decode.lanes"] == before + 40 * (2 * WARMUP_CALLS + 4)
    assert [run.counts["decode.lanes"] for run in predictor._compiled.values()] == [40, 40]
    before = profiling.counters()["decode.lanes"]
    predictor.predict(frames[:3])
    assert profiling.counters()["decode.lanes"] == before + 40 * 2


def test_ssd_r34_graphs_equal_its_eager_forward_and_fold_once(cuda):
    """SSD-ResNet34 at 1200x1200 in bf16 through the predictor's graphs:
    the BatchNorms folded once before the capture, the replayed detections
    equal to the eager path's bit for bit, 80 lanes an image."""
    from ssd_keras_torch.models import ssd_r34

    model, _ = ssd_r34(mode="inference", compute_dtype=torch.bfloat16, device=cuda,
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for i in range(6):
            getattr(model, f"conf{i}").weight.mul_(0.125)
            getattr(model, f"loc{i}").weight.mul_(0.0625)
    folded = profiling.counters().get("model.bn_folded", 0)
    cached = SSDPredictor(model, batch_size=2)
    frames = [np.random.RandomState(i).randint(0, 256, (480, 640, 3), dtype=np.uint8)
              for i in range(3)]
    got = cached.predict(frames)
    assert profiling.counters()["model.bn_folded"] == folded + 29
    assert [run.counts["decode.lanes"] for run in cached._compiled.values()] == [160]
    for dets, ref in zip(got, EagerPredictor(model, batch_size=2).predict(frames)):
        np.testing.assert_array_equal(dets, ref)
    assert profiling.counters()["model.bn_folded"] == folded + 29


def test_graph_captures_and_spans_are_counted_on_card(cuda):
    """A shape's first call captures its graph under ``predict.capture``
    and counts it; a second call replays and captures nothing."""
    predictor = SSDPredictor(_served_model(cuda), batch_size=2)
    frames = _frames(3)
    with profiling.recording():
        predictor.predict(frames)
        first = profiling.counted()
        predictor.predict(frames)
        both = profiling.counted()
        names = [s.name for s in profiling.spans()]
    assert first["predict.graph_captures"] == 2 and both["predict.graph_captures"] == 2
    assert names.count("predict.capture") == 2 and names.count("predict") == 2
    assert both["predict.slots"] == 2 * 4 * 2 and both["predict.images"] == 2 * 6


def test_a_span_encloses_its_kernels_on_the_traces_clock(cuda):
    """A span around a launch and a synchronise is an ``ssd.`` event of the
    profiler's trace whose host interval holds the kernel's device interval
    (one clock), and the profiler mirrors no span onto the card."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    for _ in range(3):  # the card's profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with profiling.span("probe"):
                (x @ x).relu_()
                torch.cuda.synchronize()
        events = list(prof.profiler.kineto_results.events())
        card = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
        if card:
            break
    host = [e for e in events if e.name() == "ssd.probe"]
    assert len(host) == 1 and host[0].device_type() == torch.autograd.DeviceType.CPU
    lo, hi = host[0].start_ns(), host[0].start_ns() + host[0].duration_ns()
    assert card and all(lo <= e.start_ns() and e.start_ns() + e.duration_ns() <= hi
                        for e in card)
    assert not [e for e in card if e.name().startswith(profiling.SPAN_PREFIX)]


def test_graph_reload_after_serving(cuda):
    """Serve, load other weights, serve again: the graphs made with the old
    weights (and their bf16 copies) are dropped, and the answer equals an
    eager predictor's on the new weights."""
    model = _served_model(cuda)
    predictor = SSDPredictor(model, batch_size=2)
    frames = _frames(3)
    old = predictor.predict(frames)
    graphs = list(predictor._compiled.values())
    model.load_state_dict(_served_model(cuda, seed=1).state_dict())
    new = predictor.predict(frames)
    assert not any(run is graphs[i] for i, run in enumerate(predictor._compiled.values()))
    for dets, ref, before in zip(new, EagerPredictor(model, batch_size=2).predict(frames), old):
        np.testing.assert_array_equal(dets, ref)
        assert not np.array_equal(dets, before)


def test_each_graph_has_its_own_nms_scratch(cuda, monkeypatch):
    """A call under capture takes its scratch from the graph's own pool:
    one per graph, none of them a scratch an eager call keeps per stream.
    Eager calls on the capture stream between replays leave the graphs'
    answers as they were."""
    taken = []
    graph_scratch = nms_kernel._graph_scratch

    def spy(device, words):
        scratch = graph_scratch(device, words)
        taken.append(scratch.data_ptr())
        return scratch

    monkeypatch.setattr(nms_kernel, "_graph_scratch", spy)
    model = _served_model(cuda)
    predictor = SSDPredictor(model, batch_size=2)
    frames = _frames(4)
    first = predictor.predict(frames)
    assert len(taken) == 2 and taken[0] != taken[1]
    eager_ptrs = {t.data_ptr() for t in nms_kernel._scratches.values()}
    assert not eager_ptrs & set(taken)
    stream = predictor._capture_stream()
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        EagerPredictor(model, batch_size=2).predict(frames)
    torch.cuda.current_stream(cuda).wait_stream(stream)
    for dets, ref in zip(predictor.predict(frames), first):
        np.testing.assert_array_equal(dets, ref)


def test_predictor_takes_gray_and_rgba_frames_on_card(cuda):
    """Gray and RGBA frames need no PIL: made RGB on the host, then resized
    on the card (or on the host with ``resize_on_device=False``); each gives
    the detections of its RGB-converted frame."""
    model, _ = ssd_300(SSDConfig.ssd300(), mode="inference", device=cuda,
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.conv1_1.weight.mul_(0.01)
    rng = np.random.RandomState(3)
    gray = rng.randint(0, 256, (240, 320), dtype=np.uint8)
    rgba = rng.randint(0, 256, (300, 300, 4), dtype=np.uint8)
    rgb = [np.repeat(gray[..., None], 3, -1), rgba[..., :3]]
    for resize_on_device in (True, False):
        predictor = SSDPredictor(model, batch_size=2, resize_on_device=resize_on_device)
        before = _count("nms.launches")
        out = predictor.predict([gray, rgba])
        assert _count("nms.launches") > before
        for dets, ref in zip(out, predictor.predict(rgb)):
            assert dets.shape[1] == 6 and len(dets) > 0 and np.isfinite(dets).all()
            np.testing.assert_array_equal(dets, ref)


def test_host_chain_trainer_steps_on_card(cuda):
    """Two bf16 steps of SSD7 from ``DataGenerator.generate`` with
    ``DataAugmentationConstantInputSize`` and an encoder on the card."""
    import random

    from ssd_keras_torch.data.chains import DataAugmentationConstantInputSize

    cfg = SSDConfig.ssd7(n_classes=20, img_height=300, img_width=300)
    model, sizes = ssd_7(cfg, compute_dtype=torch.bfloat16, device=cuda,
                         generator=torch.Generator().manual_seed(0))
    encoder = SSDInputEncoder(cfg, sizes, max_gt_boxes=8, device=cuda)
    gen = SynthVOC(8, image_size=300, seed=1).as_data_generator()
    np.random.seed(0)
    random.seed(0)
    batches = gen.generate(batch_size=4, shuffle=True,
                           transformations=[DataAugmentationConstantInputSize()],
                           label_encoder=encoder, returns=["processed_images", "encoded_labels"])
    opt = T.adam(model.parameters(), 1e-4)
    trainer = T.Trainer(model, opt, T.make_train_step(model, opt, SSDLoss()))
    history = trainer.fit_generator(batches, steps_per_epoch=2, epochs=1, verbose=False)
    assert trainer.step == 2 and np.isfinite(history["loss"]).all()


# Card-vs-CPU tolerances of the training slice (as chip_smoke.py states
# them): encoded offsets within an ulp-level 1e-5 (``log`` and division);
# one f32 step (TF32 off) with the loss within 1e-4 relative and every
# parameter within 1e-2 of the step's largest update (y_pred differs by
# ~1e-5 between the devices, and the gradients carry the same noise).
OFFSET_TOL = 1e-5
STEP_LOSS_RTOL = 1e-4
STEP_PARAM_TOL = 1e-2


@pytest.fixture()
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _synthvoc(n, max_gt=8):
    """n SynthVOC train images at 300x300 (uint8) and their padded labels."""
    images, labels = SynthVOC(n, image_size=300, seed=0).materialize()
    padded, counts = pad_labels(labels, max_gt)
    return images, padded, counts


def _seeded_ssd300_state():
    """Seeded SSD300 weights, conv1_1 x 1/100 and loc heads x 1/4 (see
    chip_smoke.seeded_state)."""
    model, _ = ssd_300(SSDConfig.ssd300(), generator=torch.Generator().manual_seed(0),
                       device="cpu")
    with torch.no_grad():
        model.conv1_1.weight.mul_(0.01)
        for name, module in model.named_children():
            if name.endswith("_mbox_loc"):
                module.weight.mul_(0.25)
    return model.state_dict()


def _step(build, state, x, y, device, dtype=torch.float32):
    model, _ = build(compute_dtype=dtype, device=device)
    model.load_state_dict(state)
    opt = T.sgd_with_momentum(model.parameters(), 1e-3, 0.9, clipnorm=5.0)
    metrics = T.make_train_step(model, opt, SSDLoss(), l2_reg=5e-4)(x.to(device), y.to(device))
    return float(metrics["loss"]), model.state_dict()


def _assert_steps_close(state, cpu, card):
    (loss_cpu, after_cpu), (loss_card, after_card) = cpu, card
    assert abs(loss_card - loss_cpu) <= STEP_LOSS_RTOL * abs(loss_cpu)
    update = max(float((after_cpu[k] - state[k]).abs().max()) for k in state)
    for k in state:
        torch.testing.assert_close(after_card[k].cpu(), after_cpu[k], rtol=0,
                                   atol=STEP_PARAM_TOL * update, msg=k)


def test_encode_on_card_equals_cpu(cuda):
    cfg = SSDConfig.ssd300()
    sizes = ssd300_predictor_sizes(300, 300)
    _, padded, counts = _synthvoc(8)
    got = SSDInputEncoder(cfg, sizes, max_gt_boxes=8, device=cuda).encode_padded(
        torch.from_numpy(padded).to(cuda), torch.from_numpy(counts).to(cuda))
    assert got.device.type == "cuda" and got.shape == (8, 8732, 33)
    expected = SSDInputEncoder(cfg, sizes, max_gt_boxes=8, device="cpu").encode_padded(
        padded, counts)
    got = got.cpu()
    assert torch.equal(got[..., :21], expected[..., :21])
    assert torch.equal(got[..., -8:], expected[..., -8:])
    torch.testing.assert_close(got[..., -12:-8], expected[..., -12:-8], rtol=0, atol=OFFSET_TOL)
    assert int(expected[..., 1:21].sum()) >= int(counts.sum())


def test_ssd300_sgd_step_on_card_matches_cpu(cuda, no_tf32):
    images, padded, counts = _synthvoc(2)
    cfg = SSDConfig.ssd300()
    y = SSDInputEncoder(cfg, ssd300_predictor_sizes(300, 300), max_gt_boxes=8,
                        device="cpu").encode_padded(padded, counts)
    x = torch.from_numpy(images.astype(np.float32))
    state = _seeded_ssd300_state()

    def build(**kw):
        return ssd_300(cfg, **kw)

    _assert_steps_close(state, _step(build, state, x, y, "cpu"), _step(build, state, x, y, cuda))


def test_train_step_with_encode_makes_no_host_sync(cuda):
    images, padded, counts = _synthvoc(4)
    cfg = SSDConfig.ssd300()
    encoder = SSDInputEncoder(cfg, ssd300_predictor_sizes(300, 300), max_gt_boxes=8, device=cuda)
    model, _ = ssd_300(cfg, compute_dtype=torch.bfloat16, device=cuda,
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.conv1_1.weight.mul_(0.01)
    opt = T.sgd_with_momentum(model.parameters(), T.linear_warmup_lr(1e-4, 8), 0.9, clipnorm=5.0)
    step = T.make_train_step(model, opt, SSDLoss(), l2_reg=5e-4)
    x = torch.from_numpy(images).to(cuda)
    p, c = torch.from_numpy(padded).to(cuda), torch.from_numpy(counts).to(cuda)
    step(x, encoder.encode_padded(p, c))  # warm-up: constants, momentum buffers
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(x, encoder.encode_padded(p, c))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(metrics["loss"]) and metrics["loss"].device.type == "cuda"
    assert all(q.dtype == torch.float32 for q in model.parameters())


def test_ssd7_batchnorm_statistics_card_equals_cpu(cuda, no_tf32):
    """SSD7 trains with batch statistics and moves its running statistics
    the flax way: the same on the card as on the CPU."""
    cfg = SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64)
    model, sizes = ssd_7(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state = model.state_dict()
    rng = np.random.RandomState(0)
    labels = [np.array([[1 + i % 3, 5.5 + i, 7.25, 40.5, 50.0 - i]]) for i in range(4)]
    y = torch.from_numpy(SSDInputEncoder(cfg, sizes, max_gt_boxes=4, device="cpu")(labels))
    x = torch.from_numpy(rng.rand(4, 64, 64, 3).astype(np.float32) * 255)

    def build(**kw):
        return ssd_7(cfg, **kw)

    cpu, card = _step(build, state, x, y, "cpu"), _step(build, state, x, y, cuda)
    _assert_steps_close(state, cpu, card)
    for k in state:
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(cpu[1][k], state[k]), k  # they moved
            torch.testing.assert_close(card[1][k].cpu(), cpu[1][k], rtol=1e-4, atol=1e-6, msg=k)


# The data-parallel path. Augmentation card vs CPU from the same draws:
# pixels (0-255) within 1e-2 and boxes within 1e-3 px (chip_smoke.py
# states why). The one-rank NCCL step against the plain step on the same
# card, with the training slice's step tolerances above: the DP loss is the
# items' sum over the global batch size where the plain one is their mean,
# an ulp apart, and SSD7's BatchNorm variance E[x^2] - E[x]^2 cancels in f32
# on large-mean activations, which amplifies such ulps in the conv1-conv3
# gradients (tests/test_torch_train.py); BatchNorm running statistics
# within rtol 1e-4, atol 1e-6.
AUG_PIXEL_TOL = 1e-2
AUG_BOX_TOL = 1e-3


def test_augmentation_on_card_equals_cpu_with_the_same_draws(cuda, no_tf32):
    images, padded, counts = _synthvoc(8, max_gt=16)
    aug = DeviceSSDAugmentation(300, 300)
    draws = aug.draw(5, 8, cuda)
    idx = torch.arange(8, device=cuda)
    draws = draws._replace(geometry=draws.geometry._replace(
        expand=draws.geometry.expand | (idx % 2 == 0), flip=idx % 3 == 0))
    card = aug.apply(draws, *(torch.from_numpy(a).to(cuda) for a in (images, padded, counts)))
    cpu = aug.apply(draws.to("cpu"), *(torch.from_numpy(a) for a in (images, padded, counts)))
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=0, atol=AUG_PIXEL_TOL)
    assert torch.equal(card[2].cpu(), cpu[2])
    assert torch.equal(card[1][..., 0].cpu(), cpu[1][..., 0])
    torch.testing.assert_close(card[1].cpu(), cpu[1], rtol=0, atol=AUG_BOX_TOL)


def test_streamed_upload_equals_the_direct_path(cuda):
    cfg = SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64)
    enc = SSDInputEncoder(cfg, ssd7_predictor_sizes(64, 64), max_gt_boxes=8, device=cuda)
    aug = DeviceSSDAugmentation(64, 64)
    rng = np.random.RandomState(0)
    host = []
    for _ in range(6):
        labels = np.zeros((4, 8, 5), np.float32)
        labels[:, 0] = [1, 10.5, 12.25, 60.75, 70.5]
        labels[:, 1] = [2, 40.5, 5.25, 90.75, 50.5]
        host.append((rng.randint(0, 256, (4, 80, 96, 3)).astype(np.uint8), labels,
                     np.full(4, 2, np.int32)))
    stream = StreamingDeviceInput(iter(host), aug, enc, seed=3, depth=2)
    got = list(stream)
    assert len(got) == len(host)
    for i, (x, y) in enumerate(got):
        assert x.device.type == "cuda"
        direct = [torch.from_numpy(a).to(cuda) for a in host[i]]
        a_x, a_p, a_c = aug(batch_seed(3, i), *direct)
        assert torch.equal(x, a_x) and torch.equal(y, enc.encode_padded(a_p, a_c))


def test_one_rank_nccl_dp_step_equals_the_plain_step(cuda, no_tf32, tmp_path):
    cfg = SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64)
    model, sizes = ssd_7(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state = model.state_dict()
    labels = [np.array([[1 + i % 3, 5.5 + i, 7.25, 40.5, 50.0 - i]]) for i in range(4)]
    y = torch.from_numpy(SSDInputEncoder(cfg, sizes, max_gt_boxes=4, device="cpu")(labels)).to(cuda)
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 64, 64, 3).astype(np.float32) * 255)
    x = x.to(cuda)

    def run(mesh):
        m, _ = ssd_7(cfg, device=cuda)
        m.load_state_dict(state)
        opt = T.sgd_with_momentum(m.parameters(), 1e-3, 0.9, clipnorm=5.0)
        step = T.make_train_step(m, opt, SSDLoss(), l2_reg=5e-4, mesh=mesh)
        metrics = step(x, y)
        # A host copy: the state dict's tensors are the parameters, which
        # the sync check's further step moves.
        return float(metrics["loss"]), {k: v.cpu() for k, v in m.state_dict().items()}, step

    plain_loss, plain_state, _ = run(None)
    sh.initialize_distributed("nccl", 1, 0,
                              store=dist.FileStore(os.path.join(tmp_path, "store"), 1))
    try:
        mesh = sh.make_mesh("cuda")
        dp_loss, dp_state, step = run(mesh)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(x, y)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        dist.destroy_process_group()
    _assert_steps_close(state, (plain_loss, plain_state), (dp_loss, dp_state))
    for k in state:
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(dp_state[k], plain_state[k], rtol=1e-4, atol=1e-6, msg=k)


def test_dryrun_on_two_gloo_ranks_sharing_the_card(cuda):
    reports = dryrun_multichip(2, device_type="cuda", timeout=300)
    assert [r["rank"] for r in reports] == [0, 1]
    assert all(r["nms_launches"] >= 1 and r["n_streamed"] == 3 for r in reports)


def test_ssd512_on_card_equals_cpu(cuda, no_tf32):
    """f32 y_pred at batch 1 within chip_smoke's Y_PRED_TOL (1e-3); the
    'inference' mode on the card launches the NMS kernel once per call."""
    from ssd_keras_torch.models import ssd_512

    state = seeded_state("ssd512")
    x = torch.from_numpy(np.random.RandomState(4).randint(0, 256, (2, 512, 512, 3)).astype(
        np.float32))

    def build(mode, device):
        model, _ = ssd_512(SSDConfig.ssd512(), mode=mode, device=device)
        model.load_state_dict(state)
        return model

    with torch.no_grad():
        y_card = build("training", cuda)(x[:1].to(cuda)).cpu()
        y_cpu = build("training", "cpu")(x[:1])
        before = _count("nms.launches")
        det = build("inference", cuda)(x.to(cuda))
        torch.cuda.synchronize()
    assert y_cpu.shape == (1, 24564, 33)
    assert float((y_card - y_cpu).abs().max()) <= 1e-3
    assert _count("nms.launches") == before + 1 and det.shape == (2, 200, 6)


def _eval_generator(images, labels):
    return SynthVOC(len(images), image_size=300).as_data_generator(images, labels)


def test_evaluator_on_card_equals_cpu_on_the_noisy_oracle(cuda):
    """The same prediction results and mAP; one NMS launch per batch."""
    from ssd_keras_torch.eval import Evaluator

    images, labels = SynthVOC(16, image_size=300, split="val", seed=1).materialize()
    enc = SSDInputEncoder(SSDConfig.ssd300(), ssd300_predictor_sizes(300, 300), max_gt_boxes=8,
                          device="cpu")
    y = noisy_oracle(enc.encode_padded(*pad_labels(labels, 8)).numpy(), seed=2)
    runs = {}
    for name, device in (("card", cuda), ("cpu", torch.device("cpu"))):
        ev = Evaluator(StreamModel(torch.from_numpy(y).to(device)), 20,
                       _eval_generator(images, labels), "training", device=device)
        before = _count("nms.launches")
        runs[name] = (ev(300, 300, 4, verbose=False), ev.prediction_results,
                      _count("nms.launches") - before)
    assert runs["card"][2] == 4 and runs["cpu"][2] == 0
    assert 0 < runs["card"][0] < 1 and abs(runs["card"][0] - runs["cpu"][0]) <= 1e-6
    for got, expected in zip(runs["card"][1], runs["cpu"][1]):
        assert len(got) == len(expected)
        for g, e in zip(got, expected):
            assert g[0] == e[0] and abs(g[1] - e[1]) <= 1e-6
            np.testing.assert_allclose(g[2:], e[2:], rtol=0, atol=0.1)


def test_coco_json_on_card_runs_the_kernel_on_80_lanes_an_image(cuda):
    from chip_smoke import nms_inputs_recorded
    from ssd_keras_torch.eval import predict_all_to_json

    cfg = SSDConfig.ssd300(n_classes=80, dataset="coco")
    model, _ = ssd_300(cfg, mode="inference", compute_dtype=torch.bfloat16, device=cuda)
    model.load_state_dict(seeded_state("ssd300", cfg))
    images, labels = SynthVOC(6, image_size=300, split="val", seed=1).materialize()
    with nms_inputs_recorded(keep=False) as lanes:
        results = predict_all_to_json(os.devnull, model, 300, 300, {i: i for i in range(1, 81)},
                                      _eval_generator(images, labels), batch_size=4,
                                      model_mode="inference", verbose=False, device=cuda)
    assert lanes == [(320, 400), (160, 400)]
    assert results and all(1 <= r["category_id"] <= 80 for r in results)


def test_host_ops_build_with_gxx_and_equal_the_numpy_loops():
    """The card's machine builds the host C++ at first use; it equals the
    NumPy loops (no card needed, but run with the card's tests)."""
    from ssd_keras_torch import decoder, native

    rng = np.random.RandomState(3)
    xy = rng.rand(300, 2) * 60
    rows = np.concatenate([rng.rand(300, 1), xy, xy + 1 + rng.rand(300, 2) * 20], axis=1)
    rows = rows.astype(np.float32).astype(np.float64)
    native.load_library()
    assert native._library_path().is_file()
    for border in ("half", "include", "exclude"):
        np.testing.assert_array_equal(decoder.greedy_nms(rows, 0.45, border),
                                      decoder.greedy_nms_numpy(rows, 0.45, border))


def test_nvjpeg_decode_holds_to_pil(cuda):
    """``chip_smoke.py`` phase 14's files as one batch on the card: each
    within phase 14's tolerances of PIL's decode, CMYK through PIL with
    PIL's shape, one nvJPEG call and one colour kernel launch."""
    from chip_smoke import held_to_pil, jpeg_fixtures, pil_decode
    from ssd_keras_torch.native import jpeg

    files = jpeg_fixtures()
    before = (_count("nvjpeg.batches"), _count("jpeg_color.launches"))
    got = jpeg.decode_jpeg_batch(list(files.values()))
    assert (_count("nvjpeg.batches") - before[0],
            _count("jpeg_color.launches") - before[1]) == (1, 1)
    for (name, data), image in zip(files.items(), got):
        held_to_pil(name, image, pil_decode(data))
    assert got[list(files).index("cmyk")].shape[-1] == 4


def test_colour_kernel_equals_plain_on_nvjpeg_planes(cuda):
    from chip_smoke import jpeg_fixtures
    from ssd_keras_torch.kernels import jpeg_color as color_kernel
    from ssd_keras_torch.native import jpeg
    from ssd_keras_torch.ops import jpeg_color

    planes, layout, out_bytes, files = jpeg.decode_planes(list(jpeg_fixtures().values()))
    assert planes.is_cuda and len(files) == len(layout) == 17  # all but the CMYK file
    got = color_kernel.ycc_to_rgb(planes, layout, out_bytes)
    assert torch.equal(got, jpeg_color.ycc_to_rgb(planes, layout, out_bytes))


@pytest.mark.parametrize("case", sorted(JPEG_COLOR_CASES))
def test_colour_kernel_equals_plain_on_edge_cases(cuda, case):
    """``chip_smoke.py`` phase 14's synthetic planes (every kind at widths
    1-500 and heights 1-375, one image alone, a 2000x1500 image among small
    ones, planes at every alignment): one launch, bit for bit the plain
    version on the card and on the CPU."""
    from chip_smoke import first_difference, jpeg_color_case
    from ssd_keras_torch.kernels import jpeg_color as color_kernel
    from ssd_keras_torch.ops import jpeg_color

    planes, layout, out_bytes = jpeg_color_case(case)
    before = _count("jpeg_color.launches")
    got = color_kernel.ycc_to_rgb(planes.to(cuda), layout, out_bytes)
    torch.cuda.synchronize()
    assert _count("jpeg_color.launches") == before + 1
    assert first_difference(got, jpeg_color.ycc_to_rgb(planes.to(cuda), layout, out_bytes),
                            layout) is None
    assert torch.equal(got.cpu(), jpeg_color.ycc_to_rgb(planes, layout, out_bytes))


def test_nvjpeg_decode_raises_with_the_file_index(cuda):
    from chip_smoke import jpeg_fixtures
    from ssd_keras_torch.native import jpeg

    good = next(iter(jpeg_fixtures().values()))
    for bad in (b"not a jpeg", good[:100]):
        with pytest.raises(ValueError, match="image 1"):
            jpeg.decode_jpeg_batch([good, bad, good])
    assert jpeg.decode_jpeg_batch([good])[0].shape == (375, 500, 3)  # still decodes


def test_nvjpeg_decode_from_several_threads(cuda):
    """Calls from 8 threads at once, batches of other sizes each: every
    answer equals the same call made alone."""
    import threading

    from chip_smoke import jpeg_fixtures
    from ssd_keras_torch.native import jpeg

    files = list(jpeg_fixtures().values())
    batches = [files[k:k + 1 + k % 5] for k in range(8)]
    want = [jpeg.decode_jpeg_batch(b) for b in batches]
    got = [None] * len(batches)

    def work(k):
        for _ in range(3):
            got[k] = jpeg.decode_jpeg_batch(batches[k])

    threads = [threading.Thread(target=work, args=(k,)) for k in range(len(batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(np.array_equal(a, b) for a, b in zip(g, w))


def test_generator_decodes_jpeg_batches_on_card(cuda, tmp_path):
    """A lazy JPEG ``DataGenerator`` decodes on the card by default, one
    nvJPEG call a batch, within phase 14's tolerances of the PIL path."""
    from chip_smoke import JPEG_COLOR_MAX, encode_jpeg, jpeg_scene
    from ssd_keras_torch.data import DataGenerator

    files, labels = [], []
    for k in range(6):
        image, boxes = jpeg_scene(k, 251, 333)
        path = tmp_path / f"{k}.jpg"
        path.write_bytes(encode_jpeg(image, quality=90))
        files.append(str(path))
        labels.append(boxes)
    out = {}
    for device in ("cuda", None):
        gen = DataGenerator(filenames=files, labels=labels, jpeg_device=device)
        before = _count("nvjpeg.batches")
        batches = gen.generate(batch_size=3, shuffle=False, returns=["processed_images"])
        out[device] = [next(batches)[0] for _ in range(2)]
        out[str(device) + "_calls"] = _count("nvjpeg.batches") - before
    assert out["cuda_calls"] == 2 and out["None_calls"] == 0
    for a, b in zip(out["cuda"], out[None]):
        assert a.shape == b.shape == (3, 251, 333, 3)
        assert np.abs(a.astype(np.int16) - b).max() <= JPEG_COLOR_MAX


# --------------------------------------------------------------------------- #
# The resize kernel and the evaluator's card path
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("src, dst", RESIZE_CASES)
def test_resize_kernel_equals_plain(cuda, src, dst, channels):
    """One launch, bit for bit the plain version (which equals
    ``resize_image_numpy``, ``tests/test_torch_resize.py``)."""
    from test_torch_resize import _image, _pack

    from ssd_keras_torch.kernels import resize as resize_kernel
    from ssd_keras_torch.ops import resize as plain

    pixels, layout = _pack([_image(sum(src) + channels, *src, channels)])
    before = _count("resize_linear.launches")
    got = resize_kernel.resize_linear_u8(pixels.to(cuda), layout, *dst)
    torch.cuda.synchronize()
    assert _count("resize_linear.launches") == before + 1 and got.is_cuda
    assert torch.equal(got.cpu(), plain.resize_linear_u8(pixels, layout, *dst))


@pytest.mark.parametrize("dst", [(512, 512), (300, 300), (31, 17)])
def test_resize_kernel_equals_plain_on_a_mixed_batch(cuda, dst):
    """The evaluation cell's two shapes, eight images, gray among them, at
    ragged offsets: one launch, bit for bit the plain version."""
    from test_torch_resize import _image, _pack

    from ssd_keras_torch.kernels import resize as resize_kernel
    from ssd_keras_torch.ops import resize as plain

    images = [_image(k, *((375, 500) if k % 3 else (500, 375)), 1 if k == 5 else 3)
              for k in range(8)]
    pixels, layout = _pack(images, gap=7)
    before = _count("resize_linear.launches")
    got = resize_kernel.resize_linear_u8(pixels.to(cuda), layout, *dst)
    again = resize_kernel.resize_linear_u8(pixels.to(cuda), layout, *dst)  # the taps cached
    torch.cuda.synchronize()
    assert _count("resize_linear.launches") == before + 2
    want = plain.resize_linear_u8(pixels, layout, *dst)
    assert torch.equal(got.cpu(), want) and torch.equal(again.cpu(), want)


def _voc_jpegs(tmp_path, n, gray=()):
    """``n`` seeded scenes of the evaluation cell's two shapes as 4:2:0 JPEG
    files at quality 90 (``gray``: those written gray), with their boxes."""
    from chip_smoke import encode_jpeg, jpeg_scene
    from PIL import Image

    files, labels = [], []
    for k in range(n):
        image, boxes = jpeg_scene(k, *((375, 500) if k % 3 else (500, 375)))
        if k in gray:
            image = np.asarray(Image.fromarray(image).convert("L"))
        path = tmp_path / f"{k}.jpg"
        path.write_bytes(encode_jpeg(image, quality=90, subsampling=2))
        files.append(str(path))
        labels.append(boxes)
    return files, labels


def test_card_path_batches_equal_the_host_chains(cuda, tmp_path):
    """The same nvJPEG files through ``_generate_on_card`` and through
    ``generate``'s host chain: the images bit for bit, the same labels and
    inverters; one resize launch and no host pixels a batch."""
    from test_torch_resize import GENERATOR_RETURNS, _assert_same_batches, _chain

    from ssd_keras_torch.data import DataGenerator

    files, labels = _voc_jpegs(tmp_path, 16, gray=(4,))
    gen = DataGenerator(filenames=files, labels=labels, image_ids=list(range(16)),
                        verbose=False)
    before = _count("resize_linear.launches")
    kw = dict(batch_size=8, shuffle=False, transformations=_chain(size=(512, 512)),
              returns=GENERATOR_RETURNS, keep_images_without_gt=True)
    card_it = gen._generate_on_card(kw["transformations"][-1], **kw)
    card = [next(card_it) for _ in range(2)]
    assert _count("resize_linear.launches") == before + 2
    assert all(b[0].is_cuda and b[0].shape == (8, 512, 512, 3) for b in card)
    host_it = gen.generate(**kw)
    host = [next(host_it) for _ in range(2)]
    _assert_same_batches([(b[0].cpu(),) + b[1:] for b in card], host)


def test_evaluator_results_equal_on_the_card_path_and_the_host_chain(cuda, tmp_path):
    """SSD300 (seeded, bf16) over 12 seeded JPEG files, b8 ('resize'
    mode): the same prediction results and mAP on both paths."""
    from ssd_keras_torch.data import DataGenerator
    from ssd_keras_torch.eval import Evaluator

    files, labels = _voc_jpegs(tmp_path, 12)
    model, _ = ssd_300(SSDConfig.ssd300(), mode="inference", compute_dtype=torch.bfloat16,
                       device=cuda)
    model.load_state_dict(seeded_state("ssd300", SSDConfig.ssd300()))
    out = {}
    for path in ("card", "host"):
        gen = DataGenerator(filenames=files, labels=labels, image_ids=list(range(12)),
                            eval_neutral=[[False] * len(b) for b in labels], verbose=False)
        if path == "host":
            gen._generate_on_card = lambda resize, **kw: gen.generate(**kw)
        before = _count("resize_linear.launches")
        ev = Evaluator(model, 20, gen, model_mode="inference", device=cuda)
        out[path] = (ev(300, 300, 8, verbose=False), ev.prediction_results,
                     _count("resize_linear.launches") - before)
    assert out["card"][2] == 2 and out["host"][2] == 0
    assert out["card"][0] == out["host"][0]
    assert out["card"][1] == out["host"][1] and sum(map(len, out["card"][1])) > 0


def test_decode_packed_back_to_back_equals_one_at_a_time(cuda):
    """Batches decoded one after another without a wait (the staged
    bitstreams restaged while the card may still decode the last batch)
    give the pixels each gives decoded alone; a CMYK file or a refused
    size leaves the batch to the host, before any decode."""
    from chip_smoke import encode_jpeg, jpeg_fixtures, jpeg_scene
    from ssd_keras_torch.native import jpeg

    rng = np.random.RandomState(0)
    big = []
    for k in range(6):
        scene, _ = jpeg_scene(k, 1500, 2000)
        noise = rng.randint(-40, 40, scene.shape)
        big.append(encode_jpeg(np.clip(scene + noise, 0, 255).astype(np.uint8), quality=95))
    batches = [big[k % 6:k % 6 + 3] + big[:k % 2] for k in range(10)]
    alone = []
    for b in batches:
        pixels, layout = jpeg.decode_packed(b, cuda)
        torch.cuda.synchronize()
        alone.append((pixels.cpu(), layout))
    together = [jpeg.decode_packed(b, cuda) for b in batches]
    torch.cuda.synchronize()
    for (a, la), (t, lt) in zip(alone, together):
        assert torch.equal(la, lt) and torch.equal(a, t.cpu())
    files = jpeg_fixtures()
    before = _count("nvjpeg.batches")
    assert jpeg.decode_packed([files["cmyk"], big[0]], cuda) is None
    assert jpeg.decode_packed(big[:2], cuda, accept=lambda h, w: w != 2000) is None
    assert _count("nvjpeg.batches") == before


# ---------------------------------------------------------------------------
# The convolutions' epilogue kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(EPILOGUE_CASES))
def test_epilogue_kernel_equals_plain_and_pytorchs_ops(cuda, case):
    """At SSD-ResNet34's and SSD300's b8 maps and the edge cases, NaN, +-0.0
    and +-inf planted: the kernel, its plain version and PyTorch's add_ /
    add_ / relu_ give the same bits, in place."""
    from ssd_keras_torch.kernels import conv_epilogue as epilogue_kernel
    from ssd_keras_torch.ops import conv_epilogue as plain_epilogue

    relu = EPILOGUE_CASES[case][3]
    y, bias, residual = epilogue_inputs(case, cuda)
    ptr, before = y.data_ptr(), _count("conv_epilogue.launches")
    got = epilogue_kernel.conv_epilogue(y, bias, residual, relu)
    assert got is y and y.data_ptr() == ptr and _count("conv_epilogue.launches") == before + 1
    plain = plain_epilogue.conv_epilogue(epilogue_inputs(case, cuda)[0], bias, residual, relu)
    library = library_epilogue(epilogue_inputs(case, cuda)[0], bias, residual, relu)
    assert same_bits(got, plain) and same_bits(got, library)


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooled_epilogue_kernel_equals_plain_and_pytorchs_ops(cuda, case):
    """At SSD-ResNet34's b8 stem map, SSD300's b8 pooled maps and the edge
    cases (NaN, +-0.0 and +-inf planted; a map of signed zeros and
    negatives under a bias of -0.0): the pooled kernel, its plain version
    and PyTorch's add_ / relu_ / max_pool2d give the same bits, in a new
    channels_last map; the input is left as it was; one call counts once
    in each counter."""
    from ssd_keras_torch.kernels import conv_epilogue as epilogue_kernel
    from ssd_keras_torch.ops import conv_epilogue as plain_epilogue

    pool = POOL_CASES[case][2]
    y, bias = pool_inputs(case, cuda)
    before = _count("conv_epilogue.launches"), _count("conv_epilogue.pooled")
    got = epilogue_kernel.conv_epilogue_pool(y, bias, pool)
    assert (_count("conv_epilogue.launches"), _count("conv_epilogue.pooled")) == (
        before[0] + 1, before[1] + 1)
    plain = plain_epilogue.conv_epilogue_pool(y, bias, pool)
    library = library_pool(pool_inputs(case, cuda)[0], bias, pool)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert same_bits(got, plain) and same_bits(got, library)
    assert same_bits(y, pool_inputs(case, cuda)[0])


def _graph_epilogues(model, frames, batch_size):
    """Captures ``model``'s graphs through a predictor, then replays: the
    epilogue calls and the pooled ones each graph holds, and the kernels'
    launches and pooled launches over one more ``predict``."""
    names = ("conv_epilogue.launches", "conv_epilogue.pooled")
    predictor = SSDPredictor(model, batch_size=batch_size)
    predictor.predict(frames)
    calls = [tuple(run.counts[k] for k in names) for run in predictor._compiled.values()]
    before = [_count(k) for k in names]
    predictor.predict(frames)
    chunks = -(-len(frames) // batch_size)
    return calls, tuple(_count(k) - b for k, b in zip(names, before)), chunks


def test_graphs_hold_and_count_the_epilogues_of_ssd300(cuda):
    frames = [np.random.RandomState(i).randint(0, 256, (480, 640, 3), dtype=np.uint8)
              for i in range(3)]
    calls, launches, chunks = _graph_epilogues(_served_model(cuda), frames, 2)
    assert calls == [(29, 4)] and launches == (29 * chunks, 4 * chunks)


def test_graphs_hold_and_count_the_epilogues_of_ssd_r34(cuda):
    from ssd_keras_torch.models import ssd_r34

    model, _ = ssd_r34(mode="inference", compute_dtype=torch.bfloat16, device=cuda,
                       generator=torch.Generator().manual_seed(0), img_height=400,
                       img_width=400)
    frames = [np.random.RandomState(i).randint(0, 256, (480, 640, 3), dtype=np.uint8)
              for i in range(3)]
    calls, launches, chunks = _graph_epilogues(model, frames, 2)
    assert calls == [(45, 1)] and launches == (45 * chunks, chunks)


def test_captured_forward_replays_count_the_epilogues(cuda):
    """The entry's captured SSD300 forward holds its 29 convolutions'
    epilogues, 4 of them pooled, and counts them at each replay, as the
    predictor's graphs do; its output is the eager forward's, bit for bit."""
    from ssd_keras_torch import graft_entry

    model = graft_entry.entry_model(cuda)
    x = torch.from_numpy(graft_entry.example_batch()).to(cuda)
    captured = graft_entry.CapturedForward(graft_entry.forward, model, x)
    assert captured.counts == {"conv_epilogue.launches": 29, "conv_epilogue.pooled": 4}
    before = _count("conv_epilogue.launches"), _count("conv_epilogue.pooled")
    out = captured(x)
    assert (_count("conv_epilogue.launches"), _count("conv_epilogue.pooled")) == (
        before[0] + 29, before[1] + 4)
    with torch.inference_mode():
        assert torch.equal(out, graft_entry.forward(model, x))


def _unfused(model, monkeypatch):
    """``model`` with its forward run while autograd records: PyTorch's own
    bias add, residual add and ReLU after each convolution."""
    forward = model.forward

    def with_grad(x):
        with torch.enable_grad():
            return forward(x)

    monkeypatch.setattr(model, "forward", with_grad, raising=False)
    return model


@pytest.mark.parametrize("arch", ["ssd300", "ssd_r34"])
def test_predictions_equal_the_grad_enabled_forwards(cuda, arch, monkeypatch):
    """Detections through the predictor's graphs (the epilogue kernel)
    equal, bit for bit, the eager predictor's with the model's forward run
    under autograd (PyTorch's ops after the same convolutions)."""
    from ssd_keras_torch.models import ssd_r34

    if arch == "ssd300":
        model = _served_model(cuda)
    else:
        model, _ = ssd_r34(mode="inference", compute_dtype=torch.bfloat16, device=cuda,
                           generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            for i in range(6):
                getattr(model, f"conf{i}").weight.mul_(0.125)
                getattr(model, f"loc{i}").weight.mul_(0.0625)
    with torch.no_grad():  # biases to add, folded ones too, as a trained model has
        gen = torch.Generator().manual_seed(1)
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.05)
            if isinstance(m, BatchNorm):
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
    frames = [np.random.RandomState(i).randint(0, 256, (480, 640, 3), dtype=np.uint8)
              for i in range(3)]
    fused = SSDPredictor(model, batch_size=2).predict(frames)
    before = _count("conv_epilogue.launches")
    unfused = EagerPredictor(_unfused(model, monkeypatch), batch_size=2).predict(frames)
    assert _count("conv_epilogue.launches") == before  # the grad-enabled forward launched none
    assert sum(len(d) for d in fused) > 0
    for dets, ref in zip(fused, unfused):
        np.testing.assert_array_equal(dets, ref)
