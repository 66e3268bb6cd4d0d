#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, evaluation and host-chain
training paths on one CUDA card.

    python3 chip_smoke.py

Phases, in order; the first failure raises and the script exits non-zero:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build the CUDA kernels from ``ssd_keras_torch/csrc`` with nvcc (sm_90a).
3. Kernel against plain: the greedy-NMS kernel's keep mask must equal its
   plain PyTorch version bit for bit, on the card and on the CPU, and its
   IoU-mask pass (pass A) must equal ``iou_suppression_mask`` word for word
   on every word pass B reads: at the main path's shapes (L = 160, 640 and
   8 lanes of K = 400) with border_delta 0 and +-1, non-prefix valid masks
   and empty lanes; at K = 64, 65 and 3000; lanes valid only in their last
   row; NaN, zero-area and inverted boxes; trained-like sparse lanes (a
   valid prefix of 0-60 rows). Two cases run again with the kernel's
   scratch pre-filled with ones (a hook in this script): pass B must read
   no word that pass A did not write.
4. Main path: SSD300 VOC at full width, batch 8, 'inference' mode on the
   card, from seeded weights: at f32 (TF32 off) against the same port on
   the CPU, at bf16 (finite, in-frame output), then 'inference_fast', then
   bf16 at batch 1. The
   NMS launch count is reset before and read after; it must have moved. The
   path must not make the host wait for the device.
5. Serving through ``SSDPredictor``'s per-shape CUDA graphs (the cast,
   resize, forward, decode and NMS kernel captured once a shape): (a) it
   answers 8 frames of 300x300, 5 of 480x640 and 1 frame, all uint8, the
   first of each shape capturing its graph; (b) each answer equals the
   eager path's (``EagerPredictor``; bit-equal expected, phase 4's
   SCORE_TOL and BOX_TOL at most); (c) replayed, the requests make no host
   synchronisation outside the predictor's read and count one NMS launch a
   replay; (d) with ``max_compiled_shapes=2`` a third shape (360x480)
   evicts the least recent graph, which is captured again when its shape
   returns, and a reload of other weights drops the graphs, every answer
   equal to the eager path's; the memory each graph's pool holds at batch
   8; (e) graphs against the eager path, interleaved over SERVE_AB_ROUNDS
   rounds of the 8 x 300x300 and 5 x 480x640 requests: ms a request (host
   clock) and the card's busy share (``torch.profiler``). A failed capture
   raises.
6. Timings (CUDA events after warm-up): SSD300 batch-8 'inference' img/s at
   bf16 and f32; at bf16, serving from the kept bf16 copies of the f32
   weights against casting them at every call and against bf16 parameters,
   interleaved; the NMS kernel and its plain version at five shapes (L=160,
   K=400 all valid; the lanes the bf16 main path hands the kernel, recorded
   by wrapping ``decoder.greedy_nms_mask_batched``; COCO's L=640; the
   ``inference_fast`` L=8; trained-like sparse lanes), each held to the
   plain version's keep mask and shown beside the kept rows, the IoU pairs
   and bytes the inputs need and the bound those give.
7. Training, SSD300 VOC at full width on 64 SynthVOC images from the seed:
   the targets of a batch of 32 encoded on the card equal those encoded on
   the CPU; one f32 SGD step (TF32 off, batch 2) on the card matches the
   same step on the CPU; ``Trainer.fit_generator`` trains with bf16 compute
   over f32 weights at batch 32 (SGD momentum 0.9, L2 5e-4, warmup to lr
   1e-4, clipnorm 5, a ``CSVLogger`` and a ``ModelCheckpoint``) and its loss
   falls; the checkpoint restores the same weights and y_pred; one train
   step with its encode makes no host synchronisation; the trained weights
   serve through 'inference' mode and the NMS kernel. Timings: the train
   step's img/s at batch 32 (bf16, images and targets on the card) and the
   encode of a batch of 32.
8. Data-parallel training with the on-device input pipeline, SSD300 VOC at
   full width: (a) ``DeviceSSDAugmentation`` on the card equals the CPU
   given the same draws (batch 32 of 300x300 SynthVOC, max_gt 32, some
   views forced to expand off the image and to flip); (b) under a real NCCL
   process group of one rank (a ``FileStore`` in a temporary directory), a
   resident uint8 dataset of 256 images is gathered -> augmented -> encoded
   -> stepped at batch 32 in bf16 by ``Trainer.fit_generator`` with a mesh
   (checkpoint, CSV, restore), with finite losses and one step, with its
   gather, augment and encode, making no host synchronisation; each rank's
   'inference' decode launches the NMS kernel; (c) ``StreamingDeviceInput``
   over the same host rows and seed yields the direct path's images and
   targets bit for bit and feeds the step; (d) two spawned gloo ranks on the
   one card, global batch 8, f32: one DP SGD step equals the one-process
   step, and each rank's decode of its 4 images launches the NMS kernel and
   gathers into the one-process decode. Timings: the augment + encode of a
   batch of 32, and the resident and streamed train img/s beside the DP step
   and the plain step on batches already on the card (the plain, DP and
   resident steps interleaved in rounds).
9. Evaluation. (a) SSD512 VOC at full width from seeded weights: f32 y_pred
   on the card against the CPU at batch 1 (Y_PRED_TOL), 'inference' at f32
   and bf16 batch 8 (in frame, the NMS kernel launched, no host sync), the
   decode of one y_pred card against CPU, the kernel against its plain
   version on SSD512's own lanes with its time and bound, and img/s at bf16
   and f32. (b) The ``Evaluator`` over 64 SynthVOC images (300x300, batches
   of 8): an oracle model (the encoder's targets, decoded on the card) must
   reach mAP >= 0.95; a noisy oracle (``noisy_oracle``) must give the same
   mAP on the card and on the CPU and within 0.01 of the host decoder, and
   again with no host sync outside the drain's wait; SSD300 'training' with
   the device decode and SSD512 'inference' (the host resize 300 -> 512)
   give a finite mAP in [0, 1] with one NMS launch a batch; the evaluator's
   img/s (host clock, whole call) and the card's busy share
   (``torch.profiler``). (c) ``predict_all_to_json`` with SSD300 COCO-81
   'inference' over 16 images (the kernel on 8 x 80 lanes a batch), then
   ``COCOEvalBBox``'s 12 stats against the same labels. (d) Folding: SSD7
   with its BatchNorms folded and SSD300 with its preprocessing folded equal
   the unfolded models (f32 y_pred within FOLD_TOL, SSD7's detections
   matched), and their bf16 batch-8 times beside the unfolded ones.

10. Host-chain training, the reference's own way of training, NumPy on the
   host (no OpenCV): (a) SSD300 VOC at full width from a SynthVOC
   ``DataGenerator`` of 256 images at 300x300 through ``generate(batch_size=
   32, shuffle=True, transformations=[SSDDataAugmentation(300, 300)],
   label_encoder=SSDInputEncoder(..., device="cuda"))`` into
   ``Trainer.fit_generator`` (bf16 over f32 weights), 2 epochs of 4 steps:
   every batch uint8 (32, 300, 300, 3) with its boxes inside the frame, one
   batch made twice from the same ``np.random`` and ``random`` seeds equal
   bit for bit, finite losses; the generator's img/s alone, the end-to-end
   train img/s, and the card's busy share over two steps
   (``torch.profiler``). (b) SSD7 (20 classes, 300x300) with
   ``DataAugmentationConstantInputSize``, as the SSD7 example builds it: 2
   steps, finite losses. (c) ``host_decode_batches`` into
   ``StreamingDeviceInput``: 4 batches of 32 through the on-device augment and
   encode into the DP step under a one-rank NCCL group, finite losses. The
   JPEG batch decoder is not ported (the card's machine has no libjpeg), so
   there is no JPEG part. No NMS launch: training decodes nothing.
11. The user workflows (``ssd_keras_torch.examples``), run as a user runs
   them: (a) ``synthetic_smoke_ssd300`` at its defaults (SSD300 bf16, 400
   steps at batch 16 on 16 images with the on-device pipeline) must halve
   its loss and recall at least SMOKE_RECALL_MIN of the training boxes at
   IoU 0.5, decoded through the NMS kernel (the JAX script's ``SMOKE PASS``
   asks for recall > 0.6, which neither the port nor the JAX package
   reaches in 400 steps at the seeds run: the line records which it
   printed); (b) ``run_workflows_synthvoc --scale quick``, each workflow
   in its own process: every row ``ok``, except the three h5 rows, which
   read ``not run: no h5py`` where h5py does not import, and the
   evaluation, COCO and inference rows each report NMS launches from their
   process; (c) ``synthvoc_benchmark`` with SSD7's recipe cut to 2000 steps
   on 1000 images must reach val mAP (sample) >= 0.20. One JSON line a
   part: seconds, img/s where the workflow reports it, the mAP or recall,
   the card.

12. The accuracy A/B workflows, cut to a few minutes: (a)
   ``bf16_vs_f32_ssd300`` (200 steps at batch 8): both arms finite, their
   step-0 losses (one init, one batch) within BF16_STEP0_RTOL; (b)
   ``aug_chain_ab`` (40 steps at batch 8 on 64 images): the host chain's and
   the device chain's arms from the same init, each with a val mAP; (c)
   ``evaluator_decode_agreement`` on 96 crowded images with an SSD300 that
   ``synthvoc_benchmark``'s recipe trains for 1000 steps here: the device
   decode (the NMS kernel) against the host decoder within the JAX script's
   rule (``AGREEMENT OK``). The full-size runs go outside this script.
13. The speed and profiling workflows at their default sizes, in this
   process: (a) ``profile_breakdown`` (SSD300 batch 8 and 32, the decoder's
   own stages timed on the trunk's y_pred, composed bit-equal to
   ``decode_detections_fixed``, every stage time finite and positive, the
   NMS kernel launched; SSD7's dispatch against its device time); (b)
   ``serving_trunk_bench --flags`` (the preprocessing fold exact at f32
   within test_fold_preprocessing_exact's tolerance and within
   FOLD_BF16_FACTOR of bf16 rounding at bf16; no block over 100% of the
   H100's bf16 peak or under its floor; ``cudnn.benchmark`` off and on,
   each in its own process that launches the NMS kernel); (c)
   ``streaming_bench`` (the loss finite, the stream's and the train's
   fractions of the upload ceiling at most STREAM_FRACTION_MAX); (d)
   ``coco_decode_bench`` (every row finite, the NMS kernel launched at
   COCO's 640 lanes without compaction).

It prints JSON lines (timings, then the kernels line), then as its last line
``{"ok": true, "device": {...}}``. With no CUDA device it raises before
printing any result. Imports torch, numpy and ssd_keras_torch only.
"""

import contextlib
import json
import os
import random
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

import torch.distributed as dist

from ssd_keras_torch import (
    SSDConfig,
    SSDInputEncoder,
    SSDLoss,
    SSDPredictor,
    fold_batchnorm,
    fold_preprocessing,
    ssd_7,
    ssd_300,
    ssd_512,
)
from ssd_keras_torch import decoder
from ssd_keras_torch import train as T
from ssd_keras_torch.data import SynthVOC
from ssd_keras_torch.data.chains import DataAugmentationConstantInputSize, SSDDataAugmentation
from ssd_keras_torch.data.device_aug import DeviceSSDAugmentation, batch_seed, geometry_from_draws
from ssd_keras_torch.data.streaming import StreamingDeviceInput, host_decode_batches
from ssd_keras_torch.decoder import decode_detections_fixed
from ssd_keras_torch.encoder import pad_labels
from ssd_keras_torch.eval import COCOEvalBBox, Evaluator, predict_all_to_json
from ssd_keras_torch.eval.evaluator import HostCopy
from ssd_keras_torch.examples.common import card_line, scale_to_trained_range
from ssd_keras_torch.kernels import build
from ssd_keras_torch.kernels import nms as nms_kernel
from ssd_keras_torch.models import ssd300_predictor_sizes
from ssd_keras_torch.ops.nms import greedy_nms_mask, iou_suppression_mask, lane_bounds, words_read
from ssd_keras_torch.parallel import sharding as sh
from ssd_keras_torch.parallel.dryrun import dp_check_rank
from ssd_keras_torch.parallel.launch import run_ranks
from ssd_keras_torch.utils.profiling import summary, time_cuda, time_device

SEED = 0
BATCH = 8
IOU_THRESHOLD = 0.45

# f32 card-vs-CPU tolerances. The two devices sum the convolutions in other
# orders (cuDNN's algorithms against oneDNN's); through 23 layers and the
# softmax that moves y_pred by ~1e-5, a decoded score by about as much and a
# box coordinate (in pixels) by ~100 times that. A flipped NMS or threshold
# decision removes a whole row, which the row matching reports.
Y_PRED_TOL = 1e-3
SCORE_TOL = 1e-4
BOX_TOL = 1e-2

# Training phase: 64 SynthVOC images, batches of 32, at most 8 boxes each.
TRAIN_IMAGES = 64
TRAIN_BATCH = 32
MAX_GT = 8
L2_REG = 5e-4
BASE_LR = 1e-4
WARMUP_STEPS = 8
EPOCHS = 5
STEPS_PER_EPOCH = 8
# Card-vs-CPU tolerances of the training phase. Encoded offsets: ``log`` and
# division may differ by an ulp between the card's and the CPU's math on
# offsets of magnitude <= ~10; a wrong match moves an offset by O(1) and
# flips a class column, which must be equal.
OFFSET_TOL = 1e-5
# One f32 SGD step at batch 2 from the same weights and targets: y_pred
# differs by ~1e-5 between the devices (Y_PRED_TOL above), the loss sums
# ~100 such terms over the positives and mined negatives, and the
# gradients carry the same summation-order noise.
STEP_LOSS_RTOL = 1e-4
STEP_PARAM_TOL = 1e-2  # of the step's largest update
# A checkpoint restored into a new module on the same card: the same
# weights bit for bit; y_pred within 1e-6 in case cuDNN picks another
# algorithm for the new module.
RESTORE_TOL = 1e-6
# Interleaved rounds of the bf16 weight-cast A/B (phase 6).
CAST_AB_ROUNDS = 20
# Interleaved rounds of the predictor's graphs against its eager path
# (phase 5), each timing both requests on both sides.
SERVE_AB_ROUNDS = 20
# Phase 3: (lanes, K, kind of lanes, border_delta); the kinds are
# random_lanes'. The cases in NMS_ONES_CASES run again from a scratch of
# all ones.
NMS_CASES = [(160, 400, "prefix", 0.0), (640, 400, "prefix", 0.0), (8, 400, "prefix", 0.0),
             (160, 400, "random", 1.0), (640, 400, "random", -1.0), (8, 400, "random", 1.0),
             (16, 64, "random", 0.0), (16, 65, "prefix", 1.0), (2, 3000, "prefix", 0.0),
             (8, 400, "last", 0.0), (24, 400, "hard", 0.0), (160, 400, "sparse", 0.0)]
NMS_ONES_CASES = {(160, 400, "random", 1.0), (24, 400, "hard", 0.0)}
# The NMS kernel's bound (phase 6): the bytes the inputs need (the valid
# rows' boxes and the valid flags) read and keep written once each at the
# card's 3.35 TB/s, and ~16 f32 operations an IoU
# pair (2 min, 2 max, 4 add/sub, 2 clamps, the product, the union's add and
# sub, the division, 2 compares) at 67 TFLOP/s of f32 outside the tensor
# cores (NVIDIA's H100 SXM data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_PAIR = 16
NMS_LIBRARY_NOTE = ("no single PyTorch call computes greedy NMS (torchvision.ops.nms is not "
                    "part of PyTorch, and the port uses no torchvision)")
# Phase 8: the input pipeline at batch 32 with up to 32 boxes an image, a
# resident dataset of 256 SynthVOC images, and two ranks at global batch 8.
AUG_BATCH = 32
AUG_MAX_GT = 32
RESIDENT_IMAGES = 256
DP_EPOCHS = 2
DP_STEPS_PER_EPOCH = 4
DP_RANKS = 2
DP_BATCH = 8
DP_TIMEOUT_S = 600
# Interleaved rounds of the plain, DP and resident steps (phase 8 timings).
STEP_ROUNDS = 8
# Augmentation card vs CPU with the same draws. Each elementwise f32 op
# rounds alike on both devices; the weight normalisation's sums and the two
# batched matmuls (TF32 off) add in other orders, a few ulps of 255. An ulp
# of a sample position would move a pixel by up to ~0.03 (an ulp of ~1000 px
# times a step of 255 between neighbours), so agreement within 1e-2 also
# says the positions are equal. Boxes take a few f32 multiplies and adds.
AUG_PIXEL_TOL = 1e-2
AUG_BOX_TOL = 1e-3
# Phase 9: evaluation over 64 SynthVOC images at 300x300 in batches of 8,
# the COCO tools over 16 of them.
EVAL_IMAGES = 64
EVAL_BATCH = 8
COCO_IMAGES = 16
# The oracle (the encoder's own targets as predictions) finds every object;
# only same-class objects overlapping past the NMS threshold suppress each
# other, which keeps its mAP just under 1.
ORACLE_MAP_MIN = 0.95
# The noisy oracle's mAP on the card and on the CPU (plain NMS): every NMS
# and threshold decision falls alike and the host code is the same, so the
# mAPs agree to rounding.
EVAL_CARD_CPU_TOL = 1e-6
# The device decoder against the host decoder: its candidate pool (the top
# 512 boxes by class score, then 400 a class) is its one approximation.
EVAL_HOST_DECODE_TOL = 0.01
# Folded against unfolded models, f32 on the card: the BN scale and 1/std
# are rounded into the f32 kernels before the sums instead of applied after.
FOLD_TOL = 1e-4
# Interleaved rounds of the folded/unfolded timings.
FOLD_ROUNDS = 10

# Phase 10: the host chain at batch 32 over 256 SynthVOC images, 2 epochs of
# 4 steps; SSD7 at batch 16 for 2 steps; 4 streamed batches.
HOST_IMAGES = 256
HOST_BATCH = 32
HOST_MAX_GT = 8
HOST_EPOCHS = 2
HOST_STEPS_PER_EPOCH = 4
HOST_TIMED_BATCHES = 3
SSD7_BATCH = 16
STREAM_BATCHES = 4

# Phase 11: the user workflows. (c) is the SynthVOC benchmark's SSD7 recipe
# cut to 2000 steps on 1000 images; the JAX package's curve reads 0.434 at
# step 2000 on 4000 images, and a broken encode, loss or decode scores ~0.
BENCH_ARGS = ["--model", "ssd7", "--steps", "2000", "--eval-every", "2000",
              "--train-images", "1000", "--val-images", "200"]
BENCH_MAP_MIN = 0.20
# (a): the smoke's recall@0.5 on its 16 training images after 400 steps.
# Neither package reaches the JAX script's recall > 0.6 at the seeds run:
# the port reads 0.21 (7 of 34 boxes, the same in every card run), 0.44,
# 0.41, 0.49, 0.44, 0.31, 0.54 and 0.54 at seeds 0-7 on the card; the JAX
# package at the code that stands read 0.53, 0.53 and 0.19 (6 of 32) at
# seeds 0-2 on the CPU. The gate sits under the lowest of both: a broken
# encode, loss, decode or NMS kernel finds no box.
SMOKE_RECALL_MIN = 0.15
# Phase 12: the A/B workflows cut to keep the script in its time limit.
# (a) 200 steps at batch 8 on 256 images (the JAX run: 2000 at 32 on 2000).
BF16_AB_ARGS = ["--steps", "200", "--batch", "8", "--train-images", "256",
                "--val-images", "64", "--warmup", "50"]
# Step 0, the same init and batch in both arms: bf16 rounds each activation
# to 8 significant bits (~0.4%), and the loss averages those errors over
# ~100 matched and mined boxes. The JAX record's step-0 pair differs by
# 6e-5 of the loss; a wrong cast or a different batch errs by far more.
BF16_STEP0_RTOL = 0.01
# (b) 40 steps at batch 8 on 64 / 32 images: the host chain runs at
# ~17 img/s on the card's machine (phase 10).
AUG_AB_ARGS = ["--steps", "40", "--batch", "8", "--train-images", "64", "--val-images", "32",
               "--eval-every", "40", "--warmup", "10"]
# (c) SSD300 trained by the SynthVOC recipe for 1000 steps on 1000 images,
# then the agreement on 96 crowded images (the JAX run: 24000 steps, 320
# images).
AGREEMENT_TRAIN_ARGS = ["--model", "ssd300", "--steps", "1000", "--train-images", "1000",
                        "--val-images", "64", "--eval-every", "1000", "--warmup", "200"]
AGREEMENT_ARGS = ["--images", "96", "--batch", "32"]
# Phase 13: the speed and profiling workflows at their default sizes.
# streaming_bench: the ceiling is the same uploads without the augment,
# encode or step, so the stream and the training from it can pass it only
# by the rounds' noise.
STREAM_FRACTION_MAX = 1.05
# serving_trunk_bench's fold of the channel swap into conv1_1: at f32 (TF32
# off) within test_fold_preprocessing_exact's tolerance (rtol = atol =
# 1e-5, the script's FOLD_RTOL/FOLD_ATOL). At bf16 the fold is not bit-exact:
# it reorders conv1_1's 27-term sums, so its outputs round differently and
# the difference grows through the trunk like bf16 rounding does. Each of
# the two bf16 graphs sits within its own rounding of the f32 graphs, which
# agree to 1e-5, so their difference is held within twice the unfolded bf16
# graph's largest |diff| from its f32 graph.
FOLD_BF16_FACTOR = 2.0
# The driver's rows that need h5py, and the rows that decode (each must
# launch the NMS kernel in its own process).
H5_ROWS = {"h5_export", "weight_sampling", "sampled_weights_load"}
DECODE_ROWS = {"ssd300_evaluation", "ssd300_evaluation_coco", "ssd300_inference"}


def log(msg):
    print(msg, flush=True)


def card_info():
    return card_line("cuda")


BUILDERS = {"ssd300": (ssd_300, SSDConfig.ssd300), "ssd512": (ssd_512, SSDConfig.ssd512)}


def model_for(state, mode, dtype, device, arch="ssd300", config=None):
    """``arch`` (SSD300 or SSD512; Pascal VOC unless ``config`` says
    otherwise) in ``mode`` holding ``state`` (f32 CPU), cast and moved."""
    build_model, default_config = BUILDERS[arch]
    model, _ = build_model(config or default_config(), mode=mode, compute_dtype=dtype,
                           device=device)
    model.load_state_dict(state)
    return model


def seeded_state(arch="ssd300", config=None, seed=SEED):
    """Weights from a seeded generator, scaled into a trained detector's
    output range (``examples.common.scale_to_trained_range``)."""
    build_model, default_config = BUILDERS[arch]
    model, _ = build_model(config or default_config(),
                           generator=torch.Generator().manual_seed(seed), device="cpu")
    return scale_to_trained_range(model).state_dict()


def random_lanes(rng, lanes, k, kind="prefix"):
    """(L, K, 4) overlapping corner boxes in a 300x300 frame, (L, K) valid.
    ``kind``: "prefix" (a valid prefix of K/2..K rows), "all", "random" (a
    non-prefix mask, every 7th lane empty), "sparse" (a trained detector's
    lanes: a valid prefix of 0..60 rows), "last" (only the last row valid)
    or "hard" (random, then ``make_hard``)."""
    centre = rng.rand(lanes, k, 2) * 300
    half = (10 + rng.rand(lanes, k, 2) * 90) / 2
    boxes = np.concatenate([centre - half, centre + half], axis=-1).astype(np.float32)
    rows = np.arange(k)[None, :]
    if kind == "prefix":
        valid = rows < rng.randint(k // 2, k + 1, size=(lanes, 1))
    elif kind == "all":
        valid = np.ones((lanes, k), bool)
    elif kind == "sparse":
        valid = rows < rng.randint(0, 61, size=(lanes, 1))
    elif kind == "last":
        valid = np.broadcast_to(rows == k - 1, (lanes, k)).copy()
    else:
        valid = rng.rand(lanes, k) > 0.4
        valid[::7] = False  # empty lanes
    if kind == "hard":
        make_hard(boxes, valid)
    return boxes, valid


def make_hard(boxes, valid):
    """In place: NaN corners in every third lane from lanes 1 and 2, zero-area
    and inverted boxes in every lane, and lane 0 valid only in its last row."""
    boxes[1::3, ::5, 0] = np.nan
    boxes[2::3, 1::6, 3] = np.nan
    boxes[:, 2::7, 2:] = boxes[:, 2::7, :2]  # zero area
    boxes[:, 3::11, 2:] = boxes[:, 3::11, :2] - 5  # inverted
    valid[0] = False
    valid[0, -1] = True


@contextlib.contextmanager
def scratch_of_ones():
    """The NMS kernel's scratch filled with all ones before each call, by a
    hook on the wrapper's ``_scratch`` in this script (the package has no
    such option): a keep mask that still equals the plain version shows
    that pass B reads no word pass A did not write."""
    scratch = nms_kernel._scratch
    nms_kernel._scratch = lambda *args: scratch(*args).fill_(-1)
    try:
        yield
    finally:
        nms_kernel._scratch = scratch


def nms_kernel_vs_plain(device):
    """Phase 3. Returns the largest |kernel - plain| over the keep flags."""
    rng = np.random.RandomState(SEED)
    max_err = 0.0
    for case in NMS_CASES:
        lanes, k, kind, d = case
        boxes, valid = random_lanes(rng, lanes, k, kind)
        b, v = torch.from_numpy(boxes).to(device), torch.from_numpy(valid).to(device)
        name = f"L={lanes} K={k} {kind} border_delta={d:+.0f}"
        read = words_read(v)
        words = nms_kernel.iou_mask(b, v, IOU_THRESHOLD, d)[read]
        plain_words = iou_suppression_mask(b, v, IOU_THRESHOLD, d)[read]
        if not torch.equal(words, plain_words):
            raise AssertionError(f"NMS mask pass != plain at {name}: "
                                 f"{int((words != plain_words).sum())} of {words.numel()} words")
        got = nms_kernel.greedy_nms_mask_batched(b, v, IOU_THRESHOLD, d)
        plain = greedy_nms_mask(b, v, IOU_THRESHOLD, d)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got != plain).float().max()))
        if not torch.equal(got, plain):
            raise AssertionError(f"NMS kernel != plain at {name}: "
                                 f"{int((got != plain).sum())} of {got.numel()} flags differ")
        cpu = greedy_nms_mask(torch.from_numpy(boxes), torch.from_numpy(valid), IOU_THRESHOLD, d)
        if not torch.equal(got.cpu(), cpu):
            raise AssertionError(f"NMS kernel != plain on the CPU at {name}")
        ones = ""
        if case in NMS_ONES_CASES:
            with scratch_of_ones():
                again = nms_kernel.greedy_nms_mask_batched(b, v, IOU_THRESHOLD, d)
            if not torch.equal(again, plain):
                raise AssertionError(f"NMS kernel from a scratch of ones != plain at {name}")
            ones = "; from a scratch of ones too"
        log(f"nms {name}: mask pass == plain on the {words.numel()} words pass B reads "
            f"({int(words.ne(0).sum())} non-zero); keep == plain (card and CPU), "
            f"{int(got.sum())} kept of {int(v.sum())} valid{ones}")
    return max_err


@contextlib.contextmanager
def nms_inputs_recorded(keep=True):
    """Yields a list that collects, per call, what the decoder hands the NMS
    kernel (``(boxes, valid)`` clones, or with ``keep=False`` their shapes),
    recorded by wrapping ``decoder.greedy_nms_mask_batched``."""
    seen = []
    inner = decoder.greedy_nms_mask_batched

    def record(boxes, valid, *args):
        seen.append((boxes.clone(), valid.clone()) if keep else tuple(valid.shape))
        return inner(boxes, valid, *args)

    decoder.greedy_nms_mask_batched = record
    try:
        yield seen
    finally:
        decoder.greedy_nms_mask_batched = inner


def record_nms_inputs(model, x):
    """The (boxes, valid) that the decoder hands the NMS kernel in one call
    of ``model(x)``."""
    with nms_inputs_recorded() as seen:
        model(x)
    if len(seen) != 1:
        raise AssertionError(f"one decode called the NMS kernel {len(seen)} times")
    return seen[0]


def nms_shapes(device, serving, x):
    """Phase 6's NMS inputs by name: (boxes, valid) on the card."""
    rng = np.random.RandomState(SEED + 3)

    def lanes(n, kind):
        return tuple(torch.from_numpy(a).to(device) for a in random_lanes(rng, n, 400, kind))

    return {"L160_all_valid": lanes(160, "all"),
            "main_path": record_nms_inputs(serving, x),
            "coco_L640_all_valid": lanes(640, "all"),
            "inference_fast_L8_all_valid": lanes(8, "all"),
            "sparse_L160": lanes(160, "sparse")}


def nms_bound(valid, keep):
    """What these inputs need of the kernel: the kept rows, the IoU pairs
    (each kept row i against the rows after it below its lane's bound),
    the bytes (the valid rows' boxes and every valid flag read, keep
    written, once each; no row past a lane's last valid row is needed) and
    the least time the card could take for them."""
    k = valid.shape[1]
    after = lane_bounds(valid)[:, None] - 1 - torch.arange(k, device=valid.device)
    pairs = int(torch.where(keep, after, 0).sum())
    nbytes = 16 * int(valid.sum()) + valid.numel() + keep.numel()
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * pairs * OPS_PER_PAIR / F32_OPS_PER_S
    return dict(kept=int(keep.sum()), pairs=pairs, bytes=nbytes, bound_ms=max(bytes_ms, ops_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def nms_timings(shapes, card):
    """Phase 6: at each shape, the NMS kernel's keep mask against its plain
    version's, then the kernel's device time, whole calls back to back
    (where the host's time per call may set the pace) and the plain
    version's time."""
    lines = []
    for name, (b, v) in shapes.items():
        def call():
            return nms_kernel.greedy_nms_mask_batched(b, v, IOU_THRESHOLD)

        keep = call()
        if not torch.equal(keep, greedy_nms_mask(b, v, IOU_THRESHOLD)):
            raise AssertionError(f"NMS kernel != plain on phase 6's {name} lanes")
        cost = nms_bound(v, keep)
        kernel_ms = summary(time_device(call, iters=50))
        call_ms = summary(time_cuda(call, iters=50))
        plain_ms = summary(time_cuda(lambda: greedy_nms_mask(b, v, IOU_THRESHOLD), 1, warmup=1))
        lines.append(dict(
            metric="nms_ms", shape=name, lanes=v.shape[0], k=v.shape[1], valid=int(v.sum()),
            **cost, kernel_ms=kernel_ms, bound_share=cost["bound_ms"] / kernel_ms["median"],
            call_ms=call_ms, plain_ms=plain_ms, library_ms=None, library_note=NMS_LIBRARY_NOTE,
            card=card))
        log(f"nms {name}: keep == plain; kernel {kernel_ms['median'] * 1e3:.1f} us on the card "
            f"(whole calls back to back {call_ms['median'] * 1e3:.1f} us), {cost['kept']} kept "
            f"of {int(v.sum())} valid, {cost['pairs']} pairs, bound "
            f"{cost['bound_ms'] * 1e3:.3f} us ({cost['bound_by']}) = "
            f"{100 * lines[-1]['bound_share']:.2f}% of the kernel's time; "
            f"plain {plain_ms['median']:.1f} ms")
    return lines


def match_rows(got, expected, score_tol, box_tol):
    """Match one image's non-zero detection rows one to one by class, score
    and box. Returns (unmatched expected rows, unmatched got rows)."""
    got = got[got[:, 1] > 0]
    expected = expected[expected[:, 1] > 0]
    free = list(range(len(got)))
    missing = []
    for row in expected:
        for j in free:
            if (got[j, 0] == row[0] and abs(got[j, 1] - row[1]) <= score_tol
                    and np.all(np.abs(got[j, 2:] - row[2:]) <= box_tol)):
                free.remove(j)
                break
        else:
            missing.append(row)
    return missing, [got[j] for j in free]


def compare_detections(name, got, expected, score_tol, box_tol):
    """Every row must match, except rows at the top-k cut (a score within
    ``score_tol`` of the last one kept), which are reported as cut flips."""
    flips = 0
    for b in range(expected.shape[0]):
        missing, extra = match_rows(got[b], expected[b], score_tol, box_tol)
        cut = expected[b][expected[b, :, 1] > 0][-1, 1]
        for row in missing + extra:
            if abs(row[1] - cut) > score_tol:
                raise AssertionError(
                    f"{name}: image {b} row {row.tolist()} has no counterpart: a "
                    "confidence or IoU threshold flip, or a wrong value")
            flips += 1
    nz = expected[..., 1] > 0
    score_err = float(np.abs(got[..., 1] - expected[..., 1])[nz].max())
    log(f"{name}: {int(nz.sum())} detections matched, {flips} top-k cut flips, "
        f"max |score diff| (same rank) {score_err:.3g}")


def check_in_frame(name, dets, height, width, n_classes):
    """Finite, a foreground class, a score in (0, 1], a positive extent, and
    the box overlapping the image (SSD decoding does not clip, so a box may
    cross the border)."""
    if not np.isfinite(dets).all():
        raise AssertionError(f"{name}: non-finite detections")
    cls, score, x1, y1, x2, y2 = dets.T
    ok = ((cls >= 1) & (cls <= n_classes) & (score > 0) & (score <= 1)
          & (x2 > x1) & (y2 > y1) & (x2 > 0) & (y2 > 0) & (x1 < width) & (y1 < height))
    if not ok.all():
        raise AssertionError(f"{name}: rows out of frame: {dets[~ok][:3].tolist()}")


class EagerPredictor(SSDPredictor):
    """The predictor without its per-shape CUDA graphs: every chunk is
    uploaded and run op by op (``SSDPredictor._eager``). The uncached side
    of phase 5's comparisons."""

    def _fused_run(self, ih, iw, dtype):
        return self._eager


@contextlib.contextmanager
def sync_checked_outside_the_predictor_read():
    """torch.cuda sync debug mode 'error', except while the predictor reads a
    chunk's detections back (the one wait it is meant to make)."""
    read = SSDPredictor._read

    def waited(out):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return read(out)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    SSDPredictor._read = staticmethod(waited)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
        SSDPredictor._read = staticmethod(read)


def serving_requests(seed, shapes):
    """uint8 requests: ``shapes`` is a list of (name, count, (h, w))."""
    rng = np.random.RandomState(seed)
    return [(name, [rng.randint(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)])
            for name, n, hw in shapes]


def same_answers(name, got, expected):
    """Two predictors' answers to one request: the same rows (bit-equal
    expected; within phase 4's SCORE_TOL and BOX_TOL at most). Returns the
    largest |diff|."""
    worst = 0.0
    for i, (g, e) in enumerate(zip(got, expected)):
        if g.shape != e.shape:
            raise AssertionError(f"{name}: image {i}: {g.shape} rows against {e.shape}")
        if len(g):
            diff = np.abs(g - e)
            if diff[:, 0].max() > 0 or diff[:, 1].max() > SCORE_TOL or diff[:, 2:].max() > BOX_TOL:
                raise AssertionError(f"{name}: image {i}: max |diff| by column "
                                     f"{diff.max(0).tolist()}")
            worst = max(worst, float(diff.max()))
    return worst


def graph_pool_bytes(graph):
    """Bytes of the segments in ``graph``'s private memory pool, from the
    allocator's snapshot; "not measured" where the snapshot has no pool ids."""
    pool = tuple(graph.pool())
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return "not measured"
    return sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) == pool)


def serving_phase(bf16, state, device, card):
    """Phase 5: ``SSDPredictor`` through its per-shape CUDA graphs. Returns
    (JSON lines, NMS launches of the first requests, launches by part)."""
    predictor = SSDPredictor(bf16, batch_size=BATCH)
    requests = serving_requests(SEED + 2, [("8 x 300x300", 8, (300, 300)),
                                           ("5 x 480x640", 5, (480, 640)),
                                           ("1 x 300x300", 1, (300, 300))])
    # (a) The requests, the first of each shape capturing its graph.
    nms_kernel.launches = 0
    answers = []
    for name, images in requests:
        new_shape = (*images[0].shape[:2], "|u1") not in predictor._compiled
        t0 = time.perf_counter()
        out = predictor.predict(images)
        ms = 1e3 * (time.perf_counter() - t0)
        if len(out) != len(images):
            raise AssertionError(f"request {name}: {len(out)} answers")
        for img, dets in zip(images, out):
            if dets.ndim != 2 or dets.shape[1] != 6 or len(dets) == 0:
                raise AssertionError(f"request {name}: detections of shape {dets.shape}")
            check_in_frame(f"request {name}", dets, img.shape[0], img.shape[1], 20)
        answers.append(out)
        log(f"request {name}: answered in {ms:.1f} ms (host clock, "
            f"{'capturing its shape' if new_shape else 'replayed'}), "
            f"{sum(len(d) for d in out)} detections")
    serve_launches = nms_kernel.launches
    if serve_launches < len(requests):
        raise AssertionError(f"serving launched the NMS kernel {serve_launches} times")
    if list(predictor._compiled) != [(480, 640, "|u1"), (300, 300, "|u1")]:
        raise AssertionError(f"graph cache holds {list(predictor._compiled)}")

    # (b) Each answer equals the eager path's.
    eager = EagerPredictor(bf16, batch_size=BATCH)
    worst = max(same_answers(f"request {name}, graph vs eager", out, eager.predict(images))
                for (name, images), out in zip(requests, answers))
    log(f"graph-cached answers vs eager: max |diff| {worst:.3g} (bit-equal expected)")

    # (c) Replays: NMS launches counted, no host sync outside the read.
    launches = {}
    nms_kernel.launches = 0
    with sync_checked_outside_the_predictor_read():
        for (name, images), out in zip(requests, answers):
            same_answers(f"request {name}, replayed", predictor.predict(images), out)
    launches["serving_graph_replays"] = nms_kernel.launches
    if nms_kernel.launches != len(requests):
        raise AssertionError(f"{len(requests)} replays counted {nms_kernel.launches} NMS launches")
    log("graph replays: no host synchronisation outside the predictor's read "
        "(torch.cuda sync debug mode 'error'); one NMS launch counted a replay")

    # (d) Two shapes at most: a third evicts the least recent, which is made
    # again when it comes back; then other weights are loaded.
    model = model_for(state, "inference", torch.bfloat16, device)
    small = SSDPredictor(model, batch_size=BATCH, max_compiled_shapes=2)
    reference = EagerPredictor(model, batch_size=BATCH)
    third = serving_requests(SEED + 3, [("2 x 360x480", 2, (360, 480))])[0]
    nms_kernel.launches = 0
    for name, images in [requests[0], requests[1], third, requests[0]]:
        same_answers(f"request {name}, two graphs at most", small.predict(images),
                     reference.predict(images))
    if list(small._compiled) != [(360, 480, "|u1"), (300, 300, "|u1")]:
        raise AssertionError(f"LRU cache holds {list(small._compiled)}")
    before = small.predict(third[1])
    model.load_state_dict(seeded_state(seed=SEED + 3))
    after = small.predict(third[1])
    same_answers("after a reload", after, reference.predict(third[1]))
    if all(np.array_equal(a, b) for a, b in zip(after, before)):
        raise AssertionError("the reloaded weights gave the old answers")
    launches["serving_graph_evict_reload"] = nms_kernel.launches
    log("max_compiled_shapes=2: a third shape evicted the least recent graph, its return "
        "captured it again, and a reload of other weights dropped the graphs; answers equal "
        "the eager path's")

    # Memory: each graph's private pool at batch 8, two shapes.
    pools = {}
    graphs = SSDPredictor(bf16, batch_size=BATCH)
    for hw in ((300, 300), (480, 640)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = graphs._fused_run(*hw, np.uint8)
        torch.cuda.synchronize()
        pools["x".join(map(str, hw))] = dict(
            reserved_delta_bytes=torch.cuda.memory_reserved() - reserved,
            pool_bytes=graph_pool_bytes(graph.graph))
    largest = max(p["reserved_delta_bytes"] for p in pools.values())
    lines = [dict(metric="ssd300_serving_graph_memory", batch=BATCH, dtype="bf16",
                  per_shape=pools, graphs_16_bytes_at_largest=16 * largest,
                  note="reserved_delta includes the static input and the warm-up's NMS "
                       "scratch for the capture stream", card=card)]
    del graphs

    # (e) Cached against eager predict, interleaved.
    ab = [requests[0], requests[1]]
    variants = {"graphs": predictor, "eager": eager}
    runs = {(v, name): [] for v in variants for name, _ in ab}
    for r in range(SERVE_AB_ROUNDS):
        order = list(variants) if r % 2 == 0 else list(variants)[::-1]
        for v in order:
            for name, images in ab:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                variants[v].predict(images)
                runs[v, name].append(1e3 * (time.perf_counter() - t0))
    busy = {}
    for v, p in variants.items():
        wall, share = busy_share(lambda: [p.predict(images) for _, images in ab])
        busy[v] = dict(wall_ms=1e3 * wall, busy_share=share)
    faster = {name: sum(g < e for g, e in zip(runs["graphs", name], runs["eager", name]))
              for name, _ in ab}
    lines.append(dict(metric="ssd300_serving_graph_ab_ms", rounds=SERVE_AB_ROUNDS, dtype="bf16",
                      batch=BATCH, **{f"{v}_{name.replace(' ', '')}": summary(t)
                                      for (v, name), t in runs.items()},
                      graphs_faster_in=faster, timer="host clock", card=card))
    lines.append(dict(metric="ssd300_serving_graph_ab_busy_share", requests=[n for n, _ in ab],
                      **busy, timer="torch.profiler over one pass of both requests", card=card))
    for line in lines:
        log(f"{line['metric']}: {json.dumps({k: v for k, v in line.items() if k != 'metric'})}")
    return lines, serve_launches, launches


def cast_ab(state, bf16, x, card):
    """What f32 weights cost bf16 serving: the 'inference' module ``bf16``
    serving from its kept bf16 copies of the weights (the main path), the
    same module casting them at every call (its copies dropped before each
    call), and a module holding bf16 parameters (nothing to cast). Rounds
    of 20 calls of each, interleaved in one process: whole processes differ
    by more than these variants do."""
    bf16_params = model_for(state, "inference", torch.bfloat16, x.device).to(torch.bfloat16)

    def cast_each_call():
        bf16._cast_cache.clear()
        return bf16(x)

    variants = {"cached": lambda: bf16(x), "cast_each_call": cast_each_call,
                "bf16_params": lambda: bf16_params(x)}
    runs = {name: [] for name in variants}
    for _ in range(CAST_AB_ROUNDS):
        for name, fn in variants.items():
            runs[name] += time_cuda(fn, iters=20, repeats=1, warmup=1)
    cost = [c - k for c, k in zip(runs["cast_each_call"], runs["cached"])]
    log(f"bf16 serving weight casts, {CAST_AB_ROUNDS} interleaved rounds: cast each call "
        f"slower than cached in {sum(d > 0 for d in cost)} of {len(cost)}")
    return dict(metric="ssd300_bf16_weight_cast_ab", batch=BATCH, rounds=CAST_AB_ROUNDS,
                **{f"{name}_ms": summary(r) for name, r in runs.items()},
                cast_cost_ms=dict(median=statistics.median(cost), min=min(cost), max=max(cost)),
                card=card)


def sgd_step(state, x, y, device):
    """One f32 SGD step (momentum 0.9, L2, lr 1e-3, clipnorm 5) from
    ``state`` on ``device``. Returns (loss, the module's state_dict)."""
    model = model_for(state, "training", torch.float32, device)
    opt = T.sgd_with_momentum(model.parameters(), 1e-3, 0.9, clipnorm=5.0)
    metrics = T.make_train_step(model, opt, SSDLoss(), l2_reg=L2_REG)(x.to(device), y.to(device))
    return float(metrics["loss"]), model.state_dict()


def bf16_trainer(state, device):
    """An SSD300 'training' module with bf16 compute over f32 weights from
    ``state``, and its Trainer: SGD momentum 0.9, L2, a linear warmup to
    BASE_LR and clipnorm 5 (the recipe from random weights)."""
    model = model_for(state, "training", torch.bfloat16, device)
    opt = T.sgd_with_momentum(model.parameters(), T.linear_warmup_lr(BASE_LR, WARMUP_STEPS),
                              0.9, clipnorm=5.0)
    step = T.make_train_step(model, opt, SSDLoss(), l2_reg=L2_REG)
    return T.Trainer(model, opt, step, base_lr=BASE_LR)


def train_phase(state, device, card):
    """Phase 7. Returns its timing lines."""
    cfg = SSDConfig.ssd300()
    sizes = ssd300_predictor_sizes(300, 300)
    n_cls = cfg.n_classes_with_background
    images, labels = SynthVOC(TRAIN_IMAGES, image_size=300, split="train", seed=SEED).materialize()
    padded, counts = pad_labels(labels, MAX_GT)
    x_all = torch.from_numpy(images).to(device)  # uint8; the model casts
    p_all, c_all = torch.from_numpy(padded).to(device), torch.from_numpy(counts).to(device)
    enc = SSDInputEncoder(cfg, sizes, max_gt_boxes=MAX_GT, device=device)
    enc_cpu = SSDInputEncoder(cfg, sizes, max_gt_boxes=MAX_GT, device="cpu")
    b = TRAIN_BATCH

    # Encode on the card against the CPU.
    y_card = enc.encode_padded(p_all[:b], c_all[:b]).cpu()
    y_cpu = enc_cpu.encode_padded(padded[:b], counts[:b])
    if not torch.equal(y_card[..., :n_cls], y_cpu[..., :n_cls]):
        rows = int((y_card[..., :n_cls] != y_cpu[..., :n_cls]).any(-1).sum())
        raise AssertionError(f"encode: {rows} class rows differ between the card and the CPU")
    if not torch.equal(y_card[..., -8:], y_cpu[..., -8:]):
        raise AssertionError("encode: anchor columns differ between the card and the CPU")
    offset_err = float((y_card[..., -12:-8] - y_cpu[..., -12:-8]).abs().max())
    n_pos = int((y_cpu[..., 1:n_cls].amax(-1) > 0).sum())
    n_neutral = int((y_cpu[..., :n_cls].sum(-1) == 0).sum())
    log(f"encode batch {b} card vs CPU: class columns equal, max |offset diff| "
        f"{offset_err:.3g} (limit {OFFSET_TOL}); {n_pos} positive and {n_neutral} "
        f"neutral anchors of {b * y_cpu.shape[1]}, {int(counts[:b].sum())} boxes")
    if offset_err > OFFSET_TOL:
        raise AssertionError("encode: offsets differ between the card and the CPU")

    # One f32 SGD step on the card against the CPU (TF32 is off).
    x2 = torch.from_numpy(images[:2].astype(np.float32))
    loss_cpu, after_cpu = sgd_step(state, x2, y_cpu[:2], "cpu")
    loss_card, after_card = sgd_step(state, x2, y_cpu[:2], device)
    update = max(float((after_cpu[k] - state[k]).abs().max()) for k in state)
    param_err = max(float((after_card[k].cpu() - after_cpu[k]).abs().max()) for k in state)
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    log(f"f32 SGD step card vs CPU: loss {loss_card:.6f} vs {loss_cpu:.6f} (rel {loss_rel:.3g}, "
        f"limit {STEP_LOSS_RTOL}); max |param diff| {param_err:.3g} = "
        f"{param_err / update:.3g} of the largest update {update:.3g} (limit {STEP_PARAM_TOL})")
    if not (loss_rel <= STEP_LOSS_RTOL and param_err <= STEP_PARAM_TOL * update):
        raise AssertionError("the f32 train step on the card differs from the CPU")

    # Training through Trainer.fit_generator, targets encoded on the card.
    def batches():
        i = 0
        while True:
            sl = slice(i * b, (i + 1) * b)
            yield x_all[sl], enc.encode_padded(p_all[sl], c_all[sl])
            i = (i + 1) % (TRAIN_IMAGES // b)

    trainer = bf16_trainer(state, device)
    launches_before = nms_kernel.launches
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "log.csv")
        callbacks = [T.CSVLogger(csv_path), T.TerminateOnNaN(),
                     T.ModelCheckpoint(tmp, monitor="loss", save_best_only=False)]
        t0 = time.perf_counter()
        history = trainer.fit_generator(batches(), steps_per_epoch=STEPS_PER_EPOCH, epochs=EPOCHS,
                                        callbacks=callbacks, verbose=False)
        fit_s = time.perf_counter() - t0
        losses = history["loss"]
        log(f"fit_generator bf16 batch {b}: {trainer.step} steps in {fit_s:.2f} s (host clock), "
            f"epoch losses {[round(v, 4) for v in losses]}")
        if len(losses) != EPOCHS or not all(np.isfinite(losses)) or trainer.terminated_on_nan:
            raise AssertionError(f"training stopped or diverged: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall: {losses}")
        if not all(p.dtype == torch.float32 for p in trainer.module.parameters()):
            raise AssertionError("a parameter is no longer f32 after bf16 training")
        with open(csv_path) as f:
            rows = f.read().strip().splitlines()
        if rows[0] != "epoch,loss" or len(rows) != EPOCHS + 1:
            raise AssertionError(f"CSVLogger wrote {rows}")

        restored = bf16_trainer(state, device)
        restored.restore_checkpoint(os.path.join(tmp, f"ckpt_{EPOCHS - 1}.pt"))
    trained = trainer.module.state_dict()
    for k, v in restored.module.state_dict().items():
        if not torch.equal(v, trained[k]):
            raise AssertionError(f"checkpoint: {k} differs after the restore")
    with torch.no_grad():
        xb = x_all[:b]
        restore_err = float((restored.module(xb) - trainer.module(xb)).abs().max())
    log(f"checkpoint round trip: state equal, step {restored.step}, max |y_pred diff| "
        f"{restore_err:.3g} (limit {RESTORE_TOL})")
    if restored.step != trainer.step or restore_err > RESTORE_TOL:
        raise AssertionError("the restored checkpoint does not reproduce the trained model")

    # One train step, with the encode of its targets, after warm-up: the host
    # waits for nothing.
    step = trainer.train_step
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(x_all[:b], enc.encode_padded(p_all[:b], c_all[:b]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("train step with encode: no host synchronisation (torch.cuda sync debug mode 'error')")

    # The trained weights serve through 'inference' mode and the NMS kernel.
    val_images, _ = SynthVOC(BATCH, image_size=300, split="val", seed=SEED).materialize()
    server = model_for(trained, "inference", torch.bfloat16, device)
    with torch.no_grad():
        det = server(torch.from_numpy(val_images).to(device)).cpu().numpy()
    serve_launches = nms_kernel.launches - launches_before
    rows = det[det[..., 1] > 0]
    check_in_frame("trained SSD300 on SynthVOC val", rows, 300, 300, 20)
    log(f"trained weights served: {len(rows)} detections in {BATCH} val images, "
        f"NMS launches {serve_launches} (training made none)")
    if det.shape != (BATCH, 200, 6) or serve_launches < 1:
        raise AssertionError("serving the trained weights did not launch the NMS kernel")

    # Timings: the train step alone (images and targets already on the card)
    # and the encode of one batch.
    timed = bf16_trainer(state, device).train_step
    xb, yb = x_all[:b], enc.encode_padded(p_all[:b], c_all[:b])
    step_ms = summary(time_cuda(lambda: timed(xb, yb), iters=10))
    encode_ms = summary(time_cuda(lambda: enc.encode_padded(p_all[:b], c_all[:b]), iters=20))
    return [
        dict(metric="ssd300_train_img_per_s", batch=b, dtype="bf16", params="f32",
             img_per_s=b * 1e3 / step_ms["median"],
             img_per_s_runs=[b * 1e3 / r for r in step_ms["runs"]],
             ms_per_step=step_ms, card=card),
        dict(metric="encode_ms", batch=b, max_gt=MAX_GT, anchors=int(y_cpu.shape[1]),
             ms=encode_ms, card=card),
    ]


def aug_card_vs_cpu(images, padded, counts, device):
    """Phase 8a: the augmentation of one batch on the card and on the CPU
    from the same draws, some views forced to expand and to flip."""
    n = AUG_BATCH
    aug = DeviceSSDAugmentation(300, 300)
    draws = aug.draw(SEED, n, device)
    idx = torch.arange(n, device=device)
    geom = draws.geometry._replace(expand=draws.geometry.expand | (idx % 4 == 0),
                                   flip=draws.geometry.flip | (idx % 2 == 0))
    draws = draws._replace(geometry=geom)
    x, p, c = images[:n], padded[:n], counts[:n]
    card = [t.cpu() for t in aug.apply(draws, torch.from_numpy(x).to(device),
                                       torch.from_numpy(p).to(device),
                                       torch.from_numpy(c).to(device))]
    cpu_draws = draws.to("cpu")
    cpu = aug.apply(cpu_draws, torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(c))
    rect, flip = geometry_from_draws(cpu_draws.geometry, torch.from_numpy(p[..., 1:5]),
                                     torch.from_numpy(c).long(), 300, 300)
    off_image = int(((rect[:, :2] < 0).any(1) | (rect[:, 2:] > 300).any(1)).sum())
    pixel_err = float((card[0] - cpu[0]).abs().max())
    if not torch.equal(card[2], cpu[2]):
        raise AssertionError(f"augmentation: kept-box counts differ, card {card[2].tolist()} "
                             f"vs CPU {cpu[2].tolist()}")
    if not torch.equal(card[1][..., 0], cpu[1][..., 0]):
        raise AssertionError("augmentation: class columns differ between the card and the CPU")
    box_err = float((card[1][..., 1:] - cpu[1][..., 1:]).abs().max())
    log(f"augmentation batch {n} card vs CPU, same draws: max |pixel diff| {pixel_err:.3g} "
        f"(limit {AUG_PIXEL_TOL}), max |box diff| {box_err:.3g} px (limit {AUG_BOX_TOL}), "
        f"counts equal ({int(cpu[2].sum())} boxes kept of {int(c.sum())}); {off_image} views "
        f"off the image, {int(flip.sum())} flipped")
    if pixel_err > AUG_PIXEL_TOL or box_err > AUG_BOX_TOL:
        raise AssertionError("augmentation on the card differs from the CPU")
    if off_image == 0 or not bool(flip.any()):
        raise AssertionError("the forced expand and flip cases did not occur")


def dp_two_ranks(state, images, y_true, device):
    """Phase 8d: two gloo ranks on the one card against one process."""
    x = images[:DP_BATCH].astype(np.float32)
    y = y_true[:DP_BATCH]
    spec = dict(arch="ssd300", config={}, device="cuda",
                state={k: v.numpy() for k, v in state.items()}, images=x, y_true=y,
                lr=1e-3, l2=L2_REG, clipnorm=5.0, decode="model")
    t0 = time.perf_counter()
    ranks = run_ranks(dp_check_rank, DP_RANKS, (spec,), timeout=DP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    loss_one, after_one = sgd_step(state, torch.from_numpy(x), torch.from_numpy(y), device)
    update = max(float((after_one[k].cpu() - state[k]).abs().max()) for k in state)
    launches = [r["nms_launches"] for r in ranks]
    for r in ranks:
        loss_rel = abs(r["loss"] - loss_one) / abs(loss_one)
        param_err = max(float(np.abs(r["state"][k] - after_one[k].cpu().numpy()).max())
                        for k in state)
        log(f"DP step, rank {r['rank']} of {DP_RANKS} (gloo, one card) vs one process: loss "
            f"{r['loss']:.6f} vs {loss_one:.6f} (rel {loss_rel:.3g}, limit {STEP_LOSS_RTOL}); "
            f"max |param diff| {param_err / update:.3g} of the largest update (limit "
            f"{STEP_PARAM_TOL})")
        if not (loss_rel <= STEP_LOSS_RTOL and param_err <= STEP_PARAM_TOL * update):
            raise AssertionError("the two-rank DP step differs from the one-process step")
    with torch.no_grad():
        one = model_for(state, "inference", torch.float32, device)(
            torch.from_numpy(x).to(device)).cpu().numpy()
    for r in ranks:
        compare_detections(f"DP decode rank {r['rank']}: {DP_BATCH // DP_RANKS} images a "
                           "rank, gathered, vs one process", r["detections"], one, SCORE_TOL,
                           BOX_TOL)
    log(f"DP decode NMS launches by rank: {launches}; {DP_RANKS} ranks ran in {spawn_s:.1f} s "
        "(host clock, spawn included)")
    if min(launches) < 1:
        raise AssertionError("a rank's decode did not launch the NMS kernel")
    return launches


def dp_phase(state, device, card, step_ms_phase7):
    """Phase 8. Returns (timing lines, the NMS launches of the DP decode
    paths)."""
    cfg = SSDConfig.ssd300()
    sizes = ssd300_predictor_sizes(300, 300)
    b = AUG_BATCH
    images, labels = SynthVOC(RESIDENT_IMAGES, image_size=300, split="train",
                              seed=SEED).materialize()
    padded, counts = pad_labels(labels, AUG_MAX_GT)

    # (a) The augmentation, card against CPU.
    aug_card_vs_cpu(images, padded, counts, device)

    # (b) The resident pipeline under a real NCCL process group of one rank.
    store_dir = tempfile.TemporaryDirectory()
    sh.initialize_distributed("nccl", 1, 0,
                              store=dist.FileStore(os.path.join(store_dir.name, "store"), 1))
    try:
        mesh = sh.make_mesh("cuda")
        resident = [sh.upload_sharded(a, mesh, device) for a in (images, padded, counts)]
        aug = DeviceSSDAugmentation(300, 300, mesh=mesh)
        enc = SSDInputEncoder(cfg, sizes, max_gt_boxes=AUG_MAX_GT, device=device)
        order = np.random.RandomState(SEED).permutation(RESIDENT_IMAGES)
        per_epoch = RESIDENT_IMAGES // b

        def rows(i):
            return order[(i % per_epoch) * b:(i % per_epoch + 1) * b]

        def resident_batch(i):
            x, p, c = sh.exchange_rows(resident, rows(i), mesh)
            a_x, a_p, a_c = aug(batch_seed(SEED, i), x, p, c)
            return a_x, enc.encode_padded(a_p, a_c)

        def resident_batches():
            i = 0
            while True:
                yield resident_batch(i)
                i += 1

        def dp_trainer():
            model = model_for(state, "training", torch.bfloat16, device)
            opt = T.sgd_with_momentum(model.parameters(),
                                      T.linear_warmup_lr(BASE_LR, WARMUP_STEPS), 0.9, clipnorm=5.0)
            step = T.make_train_step(model, opt, SSDLoss(), l2_reg=L2_REG, mesh=mesh)
            return T.Trainer(model, opt, step, base_lr=BASE_LR, mesh=mesh)

        trainer = dp_trainer()
        with tempfile.TemporaryDirectory() as ckpt_dir:
            csv_path = os.path.join(ckpt_dir, "log.csv")
            history = trainer.fit_generator(
                resident_batches(), steps_per_epoch=DP_STEPS_PER_EPOCH, epochs=DP_EPOCHS,
                callbacks=[T.CSVLogger(csv_path), T.TerminateOnNaN(),
                           T.ModelCheckpoint(ckpt_dir, monitor="loss", save_best_only=False)],
                verbose=False)
            losses = history["loss"]
            with open(csv_path) as f:
                csv_rows = f.read().strip().splitlines()
            restored = dp_trainer()
            restored.restore_checkpoint(os.path.join(ckpt_dir, f"ckpt_{DP_EPOCHS - 1}.pt"))
        log(f"DP resident pipeline (NCCL, 1 rank): gather -> augment -> encode -> bf16 step, "
            f"batch {b}, {trainer.step} steps, epoch losses {[round(v, 4) for v in losses]}")
        if len(losses) != DP_EPOCHS or not all(np.isfinite(losses)) or trainer.terminated_on_nan:
            raise AssertionError(f"DP training stopped or diverged: {losses}")
        if len(csv_rows) != DP_EPOCHS + 1 or restored.step != trainer.step:
            raise AssertionError(f"DP Trainer: CSV {csv_rows}, restored step {restored.step}")
        for k, v in restored.module.state_dict().items():
            if not torch.equal(v, trainer.module.state_dict()[k]):
                raise AssertionError(f"DP checkpoint: {k} differs after the restore")

        step = trainer.train_step
        i_sync = trainer.step
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(*resident_batch(i_sync))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        log("DP step with its gather, augment and encode: no host synchronisation "
            "(torch.cuda sync debug mode 'error')")

        # Each rank decodes its rows in 'inference' mode; the detections gathered.
        server = model_for(state, "inference", torch.float32, device)
        x8 = torch.from_numpy(images[:DP_BATCH]).to(device)
        nms_kernel.launches = 0
        with torch.no_grad():
            dets = sh.global_batch_from_local(server(x8), mesh)
        torch.cuda.synchronize()
        nccl_launches = nms_kernel.launches
        if dets.shape != (DP_BATCH, 200, 6) or nccl_launches < 1:
            raise AssertionError(f"DP decode (NCCL): shape {tuple(dets.shape)}, "
                                 f"{nccl_launches} NMS launches")
        check_in_frame("DP decode (NCCL)", dets[dets[..., 1] > 0].cpu().numpy(), 300, 300, 20)
        log(f"DP decode (NCCL, 1 rank): {int((dets[..., 1] > 0).sum())} detections, NMS "
            f"launches {nccl_launches}")

        # (c) Streamed against the direct path, on the same host rows and seed.
        n_stream = 3
        host = [(images[rows(i)], padded[rows(i)], counts[rows(i)]) for i in range(n_stream)]
        stream = StreamingDeviceInput(iter(host), aug, enc, seed=SEED)
        n_seen = 0
        for i, (s_x, s_y) in enumerate(stream):
            gathered = sh.exchange_rows(resident, rows(i), mesh)
            direct = [torch.from_numpy(a).to(device) for a in host[i]]
            if not all(torch.equal(g, d) for g, d in zip(gathered, direct)):
                raise AssertionError(f"resident gather of batch {i} != its host rows")
            a_x, a_p, a_c = aug(batch_seed(SEED, i), *direct)
            if not (torch.equal(s_x, a_x) and torch.equal(s_y, enc.encode_padded(a_p, a_c))):
                raise AssertionError(f"streamed batch {i} differs from the direct path")
            loss = float(step(s_x, s_y)["loss"])
            if not np.isfinite(loss):
                raise AssertionError(f"non-finite loss {loss} from a streamed batch")
            n_seen += 1
        if n_seen != n_stream:
            raise AssertionError(f"the stream yielded {n_seen} of {n_stream} batches")
        log(f"streamed == direct augment + encode, bit for bit, {n_stream} batches of {b}; "
            f"each fed the DP step (last loss {loss:.4f})")

        # Timings. The plain step (phase 7's, no mesh), the DP step on a
        # batch already on the card and the resident DP step, interleaved in
        # rounds: each process's host runs at its own pace, so only steps
        # timed side by side compare.
        x, p, c = sh.exchange_rows(resident, rows(0), mesh)
        aug_ms = summary(time_cuda(
            lambda: enc.encode_padded(*aug(batch_seed(SEED, 0), x, p, c)[1:]), iters=10))
        on_card = resident_batch(0)
        plain = bf16_trainer(state, device).train_step
        counter = iter(range(10 ** 6))
        variants = {"plain": lambda: plain(*on_card), "dp": lambda: step(*on_card),
                    "resident": lambda: step(*resident_batch(next(counter)))}
        runs = {name: [] for name in variants}
        for _ in range(STEP_ROUNDS):
            for name, fn in variants.items():
                runs[name] += time_cuda(fn, iters=5, repeats=1, warmup=1)
        plain_ms, step_ms, resident_ms = (summary(runs[k]) for k in ("plain", "dp", "resident"))
        dp_cost = [d - q for d, q in zip(runs["dp"], runs["plain"])]
        log(f"DP step vs plain step, {STEP_ROUNDS} interleaved rounds of 5 steps: median "
            f"{statistics.median(dp_cost):+.2f} ms a step, DP slower in "
            f"{sum(d > 0 for d in dp_cost)} of {STEP_ROUNDS}")

        def endless_host():
            i = 0
            while True:
                yield images[rows(i)], padded[rows(i)], counts[rows(i)]
                i += 1

        stream = StreamingDeviceInput(endless_host(), aug, enc, seed=SEED)
        batches = iter(stream)
        for _ in range(3):
            step(*next(batches))
        streamed = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(4):
                step(*next(batches))
            torch.cuda.synchronize()
            streamed.append(1e3 * (time.perf_counter() - t0) / 4)
        stream.stop()
        batches.close()
        streamed_ms = summary(streamed)
    finally:
        dist.destroy_process_group()
        store_dir.cleanup()

    # (d) Two ranks on the one card.
    enc_cpu = SSDInputEncoder(cfg, sizes, max_gt_boxes=AUG_MAX_GT, device="cpu")
    y_true = enc_cpu.encode_padded(padded[:DP_BATCH], counts[:DP_BATCH]).numpy()
    rank_launches = dp_two_ranks(state, images, y_true, device)

    def img_per_s(ms):
        return dict(img_per_s=b * 1e3 / ms["median"],
                    img_per_s_runs=[b * 1e3 / r for r in ms["runs"]], ms_per_step=ms)

    beside = dict(dp_step_on_card=img_per_s(step_ms), plain_step_on_card=img_per_s(plain_ms),
                  phase7_step_on_card_ms=step_ms_phase7)
    lines = [
        dict(metric="aug_encode_ms", name="device augment+encode batch 32", batch=b,
             image="300x300 uint8", max_gt=AUG_MAX_GT, ms=aug_ms, card=card),
        dict(metric="ssd300_train_resident_img_per_s", batch=b, dtype="bf16",
             path="gather + augment + encode + DP step (NCCL, 1 rank)", **img_per_s(resident_ms),
             timer="CUDA events", **beside, card=card),
        dict(metric="ssd300_train_streamed_img_per_s", batch=b, dtype="bf16",
             path="pinned upload + augment + encode + DP step (NCCL, 1 rank)",
             **img_per_s(streamed_ms), timer="host clock to a synchronize, 4 steps a run",
             **beside, card=card),
    ]
    for line in lines:
        log(f"{line['metric']}: {json.dumps({k: v for k, v in line.items() if k != 'metric'})}")
    return lines, dict(dp_decode_nccl=nccl_launches,
                       **{f"dp_decode_gloo_rank{r}": n for r, n in enumerate(rank_launches)})


def noisy_oracle(y_true, seed):
    """A detector's-like 'training'-mode stream from encoded targets
    ``y_true`` (N, boxes, C + 12) numpy f32: each class column becomes a
    softmax of 8 x the one-hot plus unit seeded noise (a matched anchor keeps
    a score near 1, a background anchor gives a foreground class more than
    0.01 about 1% of the time), and the encoded offsets get unit noise (a
    centre moved by ~0.1 of the anchor's size, a size scaled by ~e^0.2), so
    that some kept boxes miss their object at IoU 0.5 and some objects are
    found twice."""
    rng = np.random.RandomState(seed)
    y = np.array(y_true, dtype=np.float32)
    n_cls = y.shape[-1] - 12
    logits = 8.0 * y[..., :n_cls] + rng.randn(*y.shape[:2], n_cls)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    y[..., :n_cls] = e / e.sum(-1, keepdims=True)
    y[..., n_cls:n_cls + 4] += rng.randn(*y.shape[:2], 4)
    return y


class StreamModel:
    """A 'model' that returns the next rows of ``y`` at each call, in the
    order the evaluator's unshuffled batches come."""

    def __init__(self, y):
        self.y, self.i = y, 0

    def __call__(self, batch):
        out = self.y[self.i:self.i + len(batch)]
        if len(out) != len(batch):
            raise AssertionError("the evaluator asked for more batches than the stream holds")
        self.i += len(batch)
        return out


def evaluate(ev, size, device_decode=True, seconds=None):
    """``Evaluator.__call__``'s steps at its defaults, with ``device_decode``.
    With a ``seconds`` dict, the host clock's time of the predictions
    (``predict``, of which ``generate`` in the data generator) and of the
    matching and AP (``match_ap``) go there."""
    spent = [0.0]
    if seconds is not None:
        inner = ev.data_generator.generate

        def generate(*args, **kwargs):
            batches = inner(*args, **kwargs)
            while True:
                t = time.perf_counter()
                batch = next(batches)
                spent[0] += time.perf_counter() - t
                yield batch

        ev.data_generator.generate = generate
    t0 = time.perf_counter()
    ev.predict_on_dataset(size, size, EVAL_BATCH, decoding_border_pixels="include",
                          verbose=False, device_decode=device_decode)
    t1 = time.perf_counter()
    ev.get_num_gt_per_class(verbose=False)
    ev.match_predictions(verbose=False)
    ev.compute_precision_recall()
    ev.compute_average_precisions()
    mean_ap = ev.compute_mean_average_precision()
    if seconds is not None:
        del ev.data_generator.generate
        seconds.update(predict=t1 - t0, generate=spent[0], match_ap=time.perf_counter() - t1)
    return mean_ap


@contextlib.contextmanager
def sync_checked_outside_the_drain():
    """torch.cuda sync debug mode 'error', except while the evaluator's drain
    waits on a batch's event (the one wait it is meant to make)."""
    wait = HostCopy.numpy

    def waited(self):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return wait(self)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    HostCopy.numpy = waited
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
        HostCopy.numpy = wait


def busy_share(fn):
    """(wall seconds, the card's busy share) of one call of ``fn``: the union
    of the spans of the kernels and copies ``torch.profiler`` records, over
    the host clock's span of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return wall, (busy_us * 1e-6 / wall if busy_us > 0 else "not measured")


def ssd512_part(device, card):
    """Phase 9a: SSD512 VOC at full width. Returns (timing lines, NMS
    launches of its 'inference' runs)."""
    state = seeded_state("ssd512")
    x_host = np.random.RandomState(SEED + 4).randint(0, 256, (BATCH, 512, 512, 3)).astype(
        np.float32)
    x = torch.from_numpy(x_host).to(device)
    f32 = model_for(state, "inference", torch.float32, device, "ssd512")
    bf16 = model_for(state, "inference", torch.bfloat16, device, "ssd512")
    train = model_for(state, "training", torch.float32, device, "ssd512")

    nms_kernel.launches = 0
    dets = {"f32": f32(x), "bf16": bf16(x)}
    torch.cuda.synchronize()
    launches = nms_kernel.launches
    for name, det in dets.items():
        det = det.cpu().numpy()
        rows = det[det[..., 1] > 0]
        if det.shape != (BATCH, 200, 6) or len(rows) < BATCH:
            raise AssertionError(f"SSD512 {name}: shape {det.shape}, {len(rows)} detections")
        check_in_frame(f"SSD512 {name}", rows, 512, 512, 20)
    log(f"SSD512 inference f32 and bf16 batch {BATCH}: NMS launches {launches}")
    if launches < 2:
        raise AssertionError("SSD512 inference did not launch the NMS kernel in each run")

    torch.cuda.set_sync_debug_mode("error")
    try:
        bf16(x), f32(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("SSD512 inference: no host synchronisation (torch.cuda sync debug mode 'error')")

    y_card = train(x)
    y_cpu = model_for(state, "training", torch.float32, "cpu", "ssd512")(
        torch.from_numpy(x_host[:1]))
    y_err = float((y_card[:1].cpu() - y_cpu).abs().max())
    log(f"SSD512 y_pred card f32 vs CPU, batch 1: max |diff| {y_err:.3g} (limit {Y_PRED_TOL})")
    if y_cpu.shape != (1, 24564, 33) or y_err > Y_PRED_TOL:
        raise AssertionError("SSD512 y_pred on the card differs from the CPU")
    compare_detections(
        f"SSD512 decode of one y_pred (batch {BATCH}), card vs CPU",
        decode_detections_fixed(y_card, img_height=512, img_width=512).cpu().numpy(),
        decode_detections_fixed(y_card.cpu(), img_height=512, img_width=512).numpy(), 0.0, 1e-3)

    lines = nms_timings({"ssd512_main_path": record_nms_inputs(bf16, x)}, card)
    for dtype_name, model in (("bf16", bf16), ("f32", f32)):
        ms = summary(time_cuda(lambda: model(x), iters=20))
        lines.append(dict(
            metric="ssd512_inference_img_per_s", batch=BATCH, dtype=dtype_name,
            img_per_s=BATCH * 1e3 / ms["median"],
            img_per_s_runs=[BATCH * 1e3 / r for r in ms["runs"]], ms_per_batch=ms, card=card))
    return lines, launches


def evaluator_part(device, card):
    """Phase 9b: the Evaluator over SynthVOC. Returns (lines, the NMS
    launches of its runs on the card)."""
    cfg = SSDConfig.ssd300()
    images, labels = SynthVOC(EVAL_IMAGES, image_size=300, split="val", seed=SEED).materialize()

    def generator():
        return SynthVOC(EVAL_IMAGES, image_size=300, split="val",
                        seed=SEED).as_data_generator(images, labels)

    enc = SSDInputEncoder(cfg, ssd300_predictor_sizes(300, 300), max_gt_boxes=MAX_GT,
                          device=device)
    y_true = enc.encode_padded(*pad_labels(labels, MAX_GT))
    n_batches = EVAL_IMAGES // EVAL_BATCH

    # The oracle: an exact detector, decoded on the card.
    nms_kernel.launches = 0
    oracle_map = evaluate(Evaluator(StreamModel(y_true), 20, generator(), "training",
                                    device=device), 300)
    oracle_launches = nms_kernel.launches
    log(f"evaluator, oracle (the encoder's targets), device decode: mAP {oracle_map!r} "
        f"(gate >= {ORACLE_MAP_MIN}), NMS launches {oracle_launches} for {n_batches} batches")
    if not oracle_map >= ORACLE_MAP_MIN or oracle_launches != n_batches:
        raise AssertionError("the evaluator's oracle gate failed")

    # The noisy oracle on the card, on the CPU and through the host decoder.
    y_noisy = noisy_oracle(y_true.cpu().numpy(), SEED + 5)
    y_noisy_card = torch.from_numpy(y_noisy).to(device)
    maps = {}
    for name, stream, on, device_decode in (
            ("card", y_noisy_card, device, True), ("cpu", torch.from_numpy(y_noisy), "cpu", True),
            ("host_decode", y_noisy_card, device, False)):
        ev = Evaluator(StreamModel(stream), 20, generator(), "training", device=on)
        maps[name] = evaluate(ev, 300, device_decode)
    with sync_checked_outside_the_drain():
        again = evaluate(Evaluator(StreamModel(y_noisy_card), 20, generator(), "training",
                                   device=device), 300)
    log(f"evaluator, noisy oracle: mAP card {maps['card']!r}, CPU {maps['cpu']!r} (limit "
        f"{EVAL_CARD_CPU_TOL}), host decoder {maps['host_decode']!r} (limit "
        f"{EVAL_HOST_DECODE_TOL}); again with sync debug 'error' outside the drain: {again!r}")
    if not (0.0 < maps["card"] < 1.0 and abs(maps["card"] - maps["cpu"]) <= EVAL_CARD_CPU_TOL
            and abs(maps["card"] - maps["host_decode"]) <= EVAL_HOST_DECODE_TOL
            and again == maps["card"]):
        raise AssertionError("the noisy-oracle evaluations disagree")

    # Real models: SSD300 'training' + device decode, SSD512 'inference' with
    # the resize 300 -> 512 on the host. Each: a gated run, a timed run and a
    # profiled run.
    models = {
        "ssd300": (model_for(seeded_state(), "training", torch.bfloat16, device), "training",
                   300),
        "ssd512": (model_for(seeded_state("ssd512"), "inference", torch.bfloat16, device,
                             "ssd512"), "inference", 512),
    }
    lines, launches = [], {}
    for name, (model, mode, size) in models.items():
        ev = Evaluator(model, 20, generator(), mode, device=device)
        nms_kernel.launches = 0
        m = ev(size, size, EVAL_BATCH, verbose=False)
        launches[name] = nms_kernel.launches
        log(f"evaluator, {name} '{mode}' bf16 (seeded weights): mAP {m!r}, NMS launches "
            f"{launches[name]}")
        if not (np.isfinite(m) and 0.0 <= m <= 1.0) or launches[name] != n_batches:
            raise AssertionError(f"the evaluator on {name} gave mAP {m} with "
                                 f"{launches[name]} NMS launches")
        t0 = time.perf_counter()
        ev(size, size, EVAL_BATCH, verbose=False)
        wall = time.perf_counter() - t0
        prof_wall, busy = busy_share(lambda: ev(size, size, EVAL_BATCH, verbose=False))
        stages = {}
        evaluate(ev, size, seconds=stages)
        lines.append(dict(metric="evaluator_img_per_s", model=name, mode=mode, dtype="bf16",
                          batch=EVAL_BATCH, images=EVAL_IMAGES, img_per_s=EVAL_IMAGES / wall,
                          seconds=wall, timer="host clock, whole Evaluator.__call__",
                          busy_share=busy, profiled_seconds=prof_wall,
                          stage_seconds=stages, map=m, card=card))
    lines.append(dict(metric="eval_map_gates", oracle=oracle_map, noisy_card=maps["card"],
                      noisy_cpu=maps["cpu"], noisy_host_decode=maps["host_decode"],
                      images=EVAL_IMAGES, card=card))
    launches["evaluator_oracle"] = oracle_launches
    return lines, launches


def coco_part(device, card):
    """Phase 9c: ``predict_all_to_json`` with SSD300 COCO-81 'inference',
    then ``COCOEvalBBox`` against the same labels. Returns (line, launches)."""
    cfg = SSDConfig.ssd300(n_classes=80, dataset="coco")
    model = model_for(seeded_state("ssd300", cfg), "inference", torch.bfloat16, device,
                      config=cfg)
    images, labels = SynthVOC(COCO_IMAGES, image_size=300, split="val", seed=SEED).materialize()
    gen = SynthVOC(COCO_IMAGES, image_size=300, split="val",
                   seed=SEED).as_data_generator(images, labels)
    classes_to_cats = {i: i for i in range(1, 81)}
    gt = {"images": [{"id": i} for i in range(COCO_IMAGES)],
          "categories": [{"id": c, "name": str(c)} for c in classes_to_cats.values()],
          "annotations": [{"id": 1000 * i + k, "image_id": i, "category_id": int(c),
                           "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]}
                          for i, lab in enumerate(labels)
                          for k, (c, x0, y0, x1, y1) in enumerate(lab)]}
    nms_kernel.launches = 0
    with tempfile.TemporaryDirectory() as tmp, nms_inputs_recorded(keep=False) as lanes:
        results = predict_all_to_json(os.path.join(tmp, "results.json"), model, 300, 300,
                                      classes_to_cats, gen, batch_size=EVAL_BATCH,
                                      model_mode="inference", verbose=False, device=device)
    launches = nms_kernel.launches
    stats = COCOEvalBBox(gt, results).evaluate()
    log(f"COCO: {len(results)} detections of {COCO_IMAGES} images, NMS launches {launches} on "
        f"lanes {lanes}; COCOEvalBBox {json.dumps(stats)}")
    if (launches != COCO_IMAGES // EVAL_BATCH or len(stats) != 12
            or not all(np.isfinite(v) for v in stats.values())
            or any(shape[0] != EVAL_BATCH * 80 for shape in lanes)):
        raise AssertionError("the COCO tools' run failed its gate")
    return dict(metric="coco_eval", model="ssd300 coco-81 inference bf16", images=COCO_IMAGES,
                detections=len(results), lanes=[list(sh) for sh in lanes], stats=stats,
                card=card), launches


def interleaved_ms(variants):
    """Milliseconds per call of each variant, rounds of 10 calls interleaved."""
    runs = {name: [] for name in variants}
    for _ in range(FOLD_ROUNDS):
        for name, fn in variants.items():
            runs[name] += time_cuda(fn, iters=10, repeats=1, warmup=1)
    return {name: summary(r) for name, r in runs.items()}


def folding_part(device, card):
    """Phase 9d: BatchNorm folding (SSD7) and preprocessing folding
    (SSD300) against the unfolded models on the card, f32; their times at
    bf16 batch 8. Returns the timing line."""
    cfg7 = SSDConfig.ssd7()
    model7, _ = ssd_7(cfg7, generator=torch.Generator().manual_seed(SEED), device="cpu")
    rng = np.random.RandomState(SEED + 6)
    with torch.no_grad():
        # Heads at 1/10, as seeded_state scales SSD300's: scores off 1.0 and
        # boxes near their anchors (SSD7's variances are 1).
        for i in range(4, 8):
            getattr(model7, f"classes{i}").weight.mul_(0.1)
            getattr(model7, f"boxes{i}").weight.mul_(0.1)
        for i in range(1, 8):
            bn = getattr(model7, f"bn{i}")
            c = bn.running_mean.shape[0]
            bn.running_mean.copy_(torch.from_numpy(rng.randn(c).astype(np.float32) * 0.5))
            bn.running_var.copy_(torch.from_numpy(rng.rand(c).astype(np.float32) * 2 + 0.1))
            bn.weight.copy_(torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5))
            bn.bias.copy_(torch.from_numpy(rng.randn(c).astype(np.float32) * 0.2))
    state7 = model7.state_dict()
    folded7 = fold_batchnorm(state7)

    def ssd7_model(state, mode, dtype, fold_bn):
        m, _ = ssd_7(cfg7, mode=mode, compute_dtype=dtype, fold_bn=fold_bn, device=device)
        m.load_state_dict(state)
        return m

    x7 = torch.from_numpy(np.random.RandomState(SEED + 7).randint(
        0, 256, (BATCH, cfg7.img_height, cfg7.img_width, 3)).astype(np.float32)).to(device)
    y7 = ssd7_model(state7, "training", torch.float32, False)(x7)
    y7_fold = ssd7_model(folded7, "training", torch.float32, True)(x7)
    err7 = float((y7 - y7_fold).abs().max())
    compare_detections("SSD7 inference f32, BN folded vs not",
                       ssd7_model(folded7, "inference", torch.float32, True)(x7).cpu().numpy(),
                       ssd7_model(state7, "inference", torch.float32, False)(x7).cpu().numpy(),
                       FOLD_TOL, BOX_TOL)

    state300 = seeded_state()
    cfg300 = SSDConfig.ssd300()
    state300_fold, cfg300_fold = fold_preprocessing(state300, cfg300)
    x = torch.from_numpy(np.random.RandomState(SEED + 1).randint(
        0, 256, (BATCH, 300, 300, 3)).astype(np.float32)).to(device)
    y300 = model_for(state300, "training", torch.float32, device)(x)
    y300_fold = model_for(state300_fold, "training", torch.float32, device,
                          config=cfg300_fold)(x)
    err300 = float((y300 - y300_fold).abs().max())
    log(f"folding, f32 y_pred on the card: SSD7 BN folded vs not {err7:.3g}, SSD300 "
        f"preprocessing folded vs not {err300:.3g} (limit {FOLD_TOL})")
    if err7 > FOLD_TOL or err300 > FOLD_TOL:
        raise AssertionError("a folded model differs from the unfolded one")

    s7, f7 = (ssd7_model(state7, "inference", torch.bfloat16, False),
              ssd7_model(folded7, "inference", torch.bfloat16, True))
    s300 = model_for(state300, "inference", torch.bfloat16, device)
    f300 = model_for(state300_fold, "inference", torch.bfloat16, device, config=cfg300_fold)
    times = interleaved_ms({"ssd7": lambda: s7(x7), "ssd7_bn_folded": lambda: f7(x7),
                            "ssd300": lambda: s300(x),
                            "ssd300_preprocessing_folded": lambda: f300(x)})
    log(f"folding, bf16 inference batch {BATCH}, median ms: "
        + ", ".join(f"{k} {v['median']:.3f}" for k, v in times.items()))
    return dict(metric="folding_ms", batch=BATCH, dtype="bf16", mode="inference",
                rounds=FOLD_ROUNDS, ssd7_y_pred_err=err7, ssd300_y_pred_err=err300,
                **{f"{k}_ms": v for k, v in times.items()}, card=card)


def eval_phase(device, card):
    """Phase 9. Returns (timing lines, NMS launches by path)."""
    lines, ssd512_launches = ssd512_part(device, card)
    eval_lines, eval_launches = evaluator_part(device, card)
    lines += eval_lines
    coco_line, coco_launches = coco_part(device, card)
    lines += [coco_line, folding_part(device, card)]
    for line in lines:
        log(f"{line['metric']}: {json.dumps({k: v for k, v in line.items() if k != 'metric'})}")
    return lines, dict(ssd512=ssd512_launches, evaluator=eval_launches["ssd300"],
                       evaluator_ssd512=eval_launches["ssd512"],
                       evaluator_oracle=eval_launches["evaluator_oracle"], coco=coco_launches)


def check_host_batch(name, images, boxes, batch, size):
    """A host-chain batch: uint8 (batch, size, size, 3), every box inside the
    frame and not degenerate. An image may keep no box (the resize's box
    filter can remove a crop's last one), as in the reference's chain; the
    batch must hold some."""
    if images.dtype != np.uint8 or images.shape != (batch, size, size, 3):
        raise AssertionError(f"{name}: images {images.dtype} {images.shape}")
    for i, b in enumerate(boxes):
        b = np.asarray(b).reshape(-1, 5)
        if not (np.all(b[:, 1:] >= 0) and np.all(b[:, 1:] <= size)
                and np.all(b[:, 3] > b[:, 1]) and np.all(b[:, 4] > b[:, 2])):
            raise AssertionError(f"{name}: image {i} has boxes {b.tolist()}")
    if sum(len(b) for b in boxes) == 0:
        raise AssertionError(f"{name}: a batch without a box")


def host_chain_phase(state, device, card):
    """Phase 10. Returns (timing lines, its NMS launches: none)."""
    cfg = SSDConfig.ssd300()
    sizes = ssd300_predictor_sizes(300, 300)
    synth = SynthVOC(HOST_IMAGES, image_size=300, split="train", seed=SEED)
    dataset = synth.as_data_generator()
    enc = SSDInputEncoder(cfg, sizes, max_gt_boxes=HOST_MAX_GT, device=device)

    def host_chain(seed):
        """The reference's generator (examples/ssd300_training.py), the
        processed boxes added for the gate; seeds np.random and random."""
        np.random.seed(seed)
        random.seed(seed)
        return dataset.generate(batch_size=HOST_BATCH, shuffle=True,
                                transformations=[SSDDataAugmentation(300, 300)],
                                label_encoder=enc,
                                returns=["processed_images", "encoded_labels", "processed_labels"])

    def checked(gen):
        for images, y, boxes in gen:
            check_host_batch("SSD300 host chain", images, boxes, HOST_BATCH, 300)
            yield images, y

    # (a) One batch made twice from the same seeds.
    first, again = next(host_chain(SEED + 10)), next(host_chain(SEED + 10))
    if not (np.array_equal(first[0], again[0]) and np.array_equal(first[1], again[1])
            and all(np.array_equal(a, b) for a, b in zip(first[2], again[2]))):
        raise AssertionError("host chain: one batch made twice from the same seeds differs")
    check_host_batch("SSD300 host chain", first[0], first[2], HOST_BATCH, 300)
    log(f"host chain: a batch made twice from the same seeds is equal bit for bit; "
        f"{sum(len(b) for b in first[2])} boxes in {HOST_BATCH} images")

    # The generator alone: augment, stack and encode on the card.
    gen = host_chain(SEED)
    next(gen)
    t0 = time.perf_counter()
    for _ in range(HOST_TIMED_BATCHES):
        next(gen)
    gen_s = time.perf_counter() - t0

    # Training through Trainer.fit_generator from the host chain.
    trainer = bf16_trainer(state, device)
    launches_before = nms_kernel.launches
    t0 = time.perf_counter()
    history = trainer.fit_generator(checked(host_chain(SEED)),
                                    steps_per_epoch=HOST_STEPS_PER_EPOCH, epochs=HOST_EPOCHS,
                                    callbacks=[T.TerminateOnNaN()], verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    losses = history["loss"]
    n_steps = HOST_EPOCHS * HOST_STEPS_PER_EPOCH
    log(f"host-chain fit_generator bf16 batch {HOST_BATCH}: {trainer.step} steps in "
        f"{fit_s:.2f} s (host clock), epoch losses {[round(v, 4) for v in losses]}")
    if (len(losses) != HOST_EPOCHS or not all(np.isfinite(losses)) or trainer.terminated_on_nan
            or trainer.step != n_steps):
        raise AssertionError(f"host-chain training stopped or diverged: {losses}")
    busy_wall, busy = busy_share(lambda: trainer.fit_generator(
        checked(host_chain(SEED + 1)), steps_per_epoch=2, epochs=1, verbose=False))
    log(f"host-chain training, 2 steps under torch.profiler: {busy_wall:.2f} s, card busy "
        f"share {busy}")

    # (b) SSD7 with DataAugmentationConstantInputSize (examples/ssd7_training.py).
    cfg7 = SSDConfig.ssd7(n_classes=20, img_height=300, img_width=300)
    model7, sizes7 = ssd_7(cfg7, compute_dtype=torch.bfloat16, device=device,
                           generator=torch.Generator().manual_seed(SEED))
    enc7 = SSDInputEncoder(cfg7, sizes7, max_gt_boxes=HOST_MAX_GT, device=device)
    np.random.seed(SEED)
    random.seed(SEED)
    augmentation = DataAugmentationConstantInputSize(
        random_brightness=(-48, 48, 0.5), random_contrast=(0.5, 1.8, 0.5),
        random_saturation=(0.5, 1.8, 0.5), random_hue=(18, 0.5), random_flip=0.5,
        random_translate=((0.03, 0.5), (0.03, 0.5), 0.5), random_scale=(0.5, 2.0, 0.5))
    gen7 = dataset.generate(batch_size=SSD7_BATCH, shuffle=True, transformations=[augmentation],
                            label_encoder=enc7,
                            returns=["processed_images", "encoded_labels", "processed_labels"])

    def checked7():
        for images, y, boxes in gen7:
            check_host_batch("SSD7 host chain", images, boxes, len(images), 300)
            yield images, y

    opt7 = T.adam(model7.parameters(), 1e-3)
    trainer7 = T.Trainer(model7, opt7, T.make_train_step(model7, opt7, SSDLoss()))
    losses7 = trainer7.fit_generator(checked7(), steps_per_epoch=2, epochs=1,
                                     verbose=False)["loss"]
    log(f"SSD7 host chain (DataAugmentationConstantInputSize) bf16 batch {SSD7_BATCH}: "
        f"{trainer7.step} steps, loss {losses7}")
    if trainer7.step != 2 or not all(np.isfinite(losses7)):
        raise AssertionError(f"SSD7 host-chain training: {trainer7.step} steps, {losses7}")

    # (c) host_decode_batches into StreamingDeviceInput and the DP step.
    store_dir = tempfile.TemporaryDirectory()
    sh.initialize_distributed("nccl", 1, 0,
                              store=dist.FileStore(os.path.join(store_dir.name, "store"), 1))
    try:
        mesh = sh.make_mesh("cuda")
        aug = DeviceSSDAugmentation(300, 300, mesh=mesh)
        enc_dp = SSDInputEncoder(cfg, sizes, max_gt_boxes=AUG_MAX_GT, device=device)
        model = model_for(state, "training", torch.bfloat16, device)
        opt = T.sgd_with_momentum(model.parameters(), T.linear_warmup_lr(BASE_LR, WARMUP_STEPS),
                                  0.9, clipnorm=5.0)
        step = T.make_train_step(model, opt, SSDLoss(), l2_reg=L2_REG, mesh=mesh)
        stream = StreamingDeviceInput(
            host_decode_batches(dataset, AUG_BATCH, 300, 300, AUG_MAX_GT, seed=SEED),
            aug, enc_dp, seed=SEED)
        batches = iter(stream)
        stream_losses = []
        for _ in range(STREAM_BATCHES):
            x, y = next(batches)
            if x.shape != (AUG_BATCH, 300, 300, 3) or y.shape[:2] != (AUG_BATCH, 8732):
                raise AssertionError(f"streamed batch: {tuple(x.shape)} {tuple(y.shape)}")
            stream_losses.append(float(step(x, y)["loss"]))
        stream.stop()
        batches.close()
    finally:
        dist.destroy_process_group()
        store_dir.cleanup()
    log(f"host_decode_batches -> StreamingDeviceInput -> DP step (NCCL, 1 rank): "
        f"{STREAM_BATCHES} batches of {AUG_BATCH}, losses {[round(v, 4) for v in stream_losses]}")
    if not all(np.isfinite(stream_losses)):
        raise AssertionError(f"streamed host batches gave losses {stream_losses}")
    host_launches = nms_kernel.launches - launches_before
    if host_launches:
        raise AssertionError("host-chain training launched the NMS kernel")

    lines = [
        dict(metric="host_chain_img_per_s", chain="SSDDataAugmentation(300, 300)",
             path="DataGenerator.generate: augment + stack + encode on the card", batch=HOST_BATCH,
             img_per_s=HOST_TIMED_BATCHES * HOST_BATCH / gen_s, seconds=gen_s,
             batches=HOST_TIMED_BATCHES, timer="host clock", card=card),
        dict(metric="ssd300_train_host_chain_img_per_s", batch=HOST_BATCH, dtype="bf16",
             params="f32", path="host chain -> Trainer.fit_generator", steps=n_steps,
             img_per_s=n_steps * HOST_BATCH / fit_s, seconds=fit_s,
             busy_share=busy, busy_wall_s=busy_wall, busy_steps=2,
             timer="host clock to a synchronize, first step included", card=card),
    ]
    for line in lines:
        log(f"{line['metric']}: {json.dumps({k: v for k, v in line.items() if k != 'metric'})}")
    return lines, host_launches


def workflows_phase(card):
    """Phase 11, the user workflows of ``ssd_keras_torch.examples`` as a user
    runs them. Returns (JSON lines, NMS launches by part)."""
    from ssd_keras_torch.examples import (run_workflows_synthvoc, synthetic_smoke_ssd300,
                                          synthvoc_benchmark)

    lines, launches = [], {}
    with tempfile.TemporaryDirectory() as tmp, torch.enable_grad():
        # (a) The overfit smoke at its defaults, in this process.
        nms_kernel.launches = 0
        t0 = time.perf_counter()
        smoke = synthetic_smoke_ssd300.main([])
        torch.cuda.synchronize()
        smoke_s = time.perf_counter() - t0
        launches["workflow_smoke"] = nms_kernel.launches
        if not (smoke["last_loss"] < 0.5 * smoke["first_loss"]
                and smoke["recall"] >= SMOKE_RECALL_MIN and launches["workflow_smoke"]):
            raise AssertionError(f"synthetic_smoke_ssd300: {smoke}, recall at least "
                                 f"{SMOKE_RECALL_MIN} wanted, "
                                 f"{launches['workflow_smoke']} NMS launches")
        lines.append(dict(metric="workflow_synthetic_smoke_ssd300",
                          result="SMOKE PASS" if smoke["passed"] else "SMOKE WEAK",
                          recall=smoke["recall"], recall_min=SMOKE_RECALL_MIN, seconds=smoke_s,
                          img_per_s=smoke["img_per_s"], loss=[smoke["first_loss"],
                                                               smoke["last_loss"]],
                          steps=smoke["steps"], batch=smoke["batch"], timer="host clock",
                          card=card))

        # (b) The driver at quick scale: each workflow in its own process.
        t0 = time.perf_counter()
        rows = run_workflows_synthvoc.run_workflows(run_workflows_synthvoc.parse_args(
            ["--scale", "quick", "--root", os.path.join(tmp, "workflows")]))
        driver_s = time.perf_counter() - t0
        h5 = run_workflows_synthvoc.have_h5py()
        for r in rows:
            allowed = {"ok"} if h5 or r["workflow"] not in H5_ROWS else {
                run_workflows_synthvoc.NOT_RUN_H5}
            if r["status"] not in allowed:
                raise AssertionError(f"workflow {r['workflow']}: {r['status']}\n{r['tail']}")
            if r["workflow"] in DECODE_ROWS and not r["nms_launches"]:
                raise AssertionError(f"workflow {r['workflow']} launched no NMS kernel")
        names = [r["workflow"] for r in rows]
        if len(rows) != 8 or set(names) - H5_ROWS != DECODE_ROWS | {"ssd300_training",
                                                                      "ssd7_training"}:
            raise AssertionError(f"the driver ran the rows {names}")
        for r in rows:
            if r["nms_launches"] is not None:
                launches[f"workflow_driver_{r['workflow']}"] = r["nms_launches"]
        lines.append(dict(metric="workflow_driver_quick", seconds=driver_s, h5py=h5,
                          rows=[{k: r[k] for k in ("workflow", "status", "seconds", "nms_launches")}
                                for r in rows], timer="host clock", card=card))

        # (c) The SynthVOC benchmark's SSD7 recipe, cut to 2000 steps.
        nms_kernel.launches = 0
        t0 = time.perf_counter()
        bench = synthvoc_benchmark.main(BENCH_ARGS + ["--out", os.path.join(tmp, "bench"),
                                                      "--ckpt", os.path.join(tmp, "ckpt")])
        torch.cuda.synchronize()
        bench_s = time.perf_counter() - t0
        launches["workflow_benchmark"] = nms_kernel.launches
        lines.append(dict(metric="workflow_synthvoc_benchmark_ssd7", args=BENCH_ARGS,
                          map_sample=bench["map_sample"], map_integrate=bench["map_integrate"],
                          map_min=BENCH_MAP_MIN, img_per_s=bench["img_per_s"],
                          train_seconds=bench["train_seconds"],
                          render_seconds=bench["render_seconds"], seconds=bench_s,
                          timer="host clock", card=card))
        if bench["map_sample"] < BENCH_MAP_MIN or not launches["workflow_benchmark"]:
            raise AssertionError(f"synthvoc_benchmark ssd7: val mAP {bench['map_sample']} "
                                 f"(at least {BENCH_MAP_MIN}), "
                                 f"{launches['workflow_benchmark']} NMS launches")
    for line in lines:
        log(f"{line['metric']}: {json.dumps({k: v for k, v in line.items() if k != 'metric'})}")
    return lines, launches


def ab_workflows_phase(card):
    """Phase 12, the three accuracy A/B workflows at a cut size. Returns
    (JSON lines, NMS launches by part)."""
    from ssd_keras_torch.examples import (aug_chain_ab, bf16_vs_f32_ssd300,
                                          evaluator_decode_agreement, synthvoc_benchmark)

    lines, launches = [], {}
    with tempfile.TemporaryDirectory() as tmp, torch.enable_grad():
        # (a) bf16 against f32 from one init on one batch sequence.
        nms_kernel.launches = 0
        t0 = time.perf_counter()
        bf = bf16_vs_f32_ssd300.main(BF16_AB_ARGS + ["--out", os.path.join(tmp, "bf16.md")])
        torch.cuda.synchronize()
        launches["workflow_bf16_vs_f32"] = nms_kernel.launches
        rec, paired = bf["record"], bf["paired"]
        step0 = paired[0]
        losses = [v for row in paired for v in row[1:3]]
        lines.append(dict(metric="workflow_bf16_vs_f32_ssd300", args=BF16_AB_ARGS, record=rec,
                          step0_loss=step0[1:3], step0_rtol=BF16_STEP0_RTOL,
                          seconds=time.perf_counter() - t0, timer="host clock", card=card))
        if not (np.isfinite(losses).all() and abs(step0[3]) <= BF16_STEP0_RTOL * abs(step0[2])
                and launches["workflow_bf16_vs_f32"]):
            raise AssertionError(f"bf16_vs_f32_ssd300: step 0 {step0}, record {rec}, "
                                 f"{launches['workflow_bf16_vs_f32']} NMS launches")

        # (b) The host chain against the device chain, from one init.
        nms_kernel.launches = 0
        t0 = time.perf_counter()
        ab = aug_chain_ab.main(AUG_AB_ARGS + ["--out", os.path.join(tmp, "aug")])
        torch.cuda.synchronize()
        launches["workflow_aug_chain_ab"] = nms_kernel.launches
        arms = {r["arm"]: r for r in ab["results"]}
        lines.append(dict(metric="workflow_aug_chain_ab", args=AUG_AB_ARGS,
                          **{f"{arm}_map": [r["final_mAP_sample"], r["final_mAP_integrate"]]
                             for arm, r in arms.items()},
                          train_seconds={arm: r["train_seconds"] for arm, r in arms.items()},
                          delta=ab["delta"], seconds=time.perf_counter() - t0,
                          timer="host clock", card=card))
        maps = [v for r in arms.values() for v in (r["final_mAP_sample"], r["final_mAP_integrate"])]
        if not (set(arms) == {"device", "host"}
                and arms["device"]["init_checksum"] == arms["host"]["init_checksum"]
                and all(0.0 <= m <= 1.0 for m in maps) and launches["workflow_aug_chain_ab"]):
            raise AssertionError(f"aug_chain_ab: {ab}, "
                                 f"{launches['workflow_aug_chain_ab']} NMS launches")

        # (c) Device decode against host decode on crowded scenes, with an
        # SSD300 the SynthVOC recipe trained here.
        t0 = time.perf_counter()
        ckpt = os.path.join(tmp, "ckpt300")
        trained = synthvoc_benchmark.main(AGREEMENT_TRAIN_ARGS + [
            "--out", os.path.join(tmp, "bench300"), "--ckpt", ckpt])
        train_s = time.perf_counter() - t0
        nms_kernel.launches = 0
        agree = evaluator_decode_agreement.main(AGREEMENT_ARGS + [
            "--ckpt", ckpt, "--out", os.path.join(tmp, "agreement.md")])
        torch.cuda.synchronize()
        launches["workflow_decode_agreement"] = nms_kernel.launches
        lines.append(dict(metric="workflow_evaluator_decode_agreement", args=AGREEMENT_ARGS,
                          trained=dict(args=AGREEMENT_TRAIN_ARGS, map_sample=trained["map_sample"],
                                       seconds=train_s),
                          record=agree["record"], ok=agree["ok"],
                          seconds=time.perf_counter() - t0, timer="host clock", card=card))
        if not (agree["ok"] and launches["workflow_decode_agreement"]):
            raise AssertionError(f"evaluator_decode_agreement: {agree['record']}, "
                                 f"{launches['workflow_decode_agreement']} NMS launches")
    for line in lines:
        log(f"{line['metric']}: {json.dumps({k: v for k, v in line.items() if k != 'metric'})}")
    return lines, launches


def speed_workflows_phase(card):
    """Phase 13, the four speed and profiling workflows at their default
    sizes, each ``main`` with its record in a temporary directory. Returns
    (JSON lines, NMS launches by path)."""
    from ssd_keras_torch.examples import (coco_decode_bench, profile_breakdown,
                                          serving_trunk_bench, streaming_bench)

    lines, launches = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) The trunk and the decoder's own stages; SSD7's launch overhead.
        nms_kernel.launches = 0
        t0 = time.perf_counter()
        prof = profile_breakdown.main(["--out", os.path.join(tmp, "profile.md")])
        torch.cuda.synchronize()
        launches["speed_profile_breakdown"] = nms_kernel.launches
        stage_ms = [row[k] for row in prof["ssd300"] for k in profile_breakdown.STAGE_KEYS]
        lines.append(dict(metric="speed_profile_breakdown", ssd300=prof["ssd300"],
                          ssd7=prof["ssd7"], seconds=time.perf_counter() - t0,
                          timer="CUDA events", card=card))
        if not (all(row["stages_equal_decoder"] and row["nms_impl"] == "cuda"
                    and row["nms_launches"] > 0 for row in prof["ssd300"])
                and all(np.isfinite(t) and t > 0 for t in stage_ms)
                and launches["speed_profile_breakdown"]):
            raise AssertionError(f"profile_breakdown: {prof['ssd300']}, "
                                 f"{launches['speed_profile_breakdown']} NMS launches")

        # (b) The preprocessing fold, the blocks' roofline, the cuDNN sweep.
        t0 = time.perf_counter()
        trunk = serving_trunk_bench.main(["--flags", "--out", os.path.join(tmp, "trunk.md")])
        pre, blocks, flags = trunk["preprocessing"], trunk["blocks"], trunk["flag_sweep"]
        launches["speed_serving_trunk_flags"] = sum(r["nms_launches"] for r in flags.values())
        lines.append(dict(metric="speed_serving_trunk", preprocessing=pre, blocks=blocks,
                          blocks_total_ms=trunk["blocks_total_ms"],
                          blocks_total_floor_ms=trunk["blocks_total_floor_ms"],
                          flag_sweep=flags, peaks=trunk["peaks"],
                          fold_bf16_factor=FOLD_BF16_FACTOR,
                          seconds=time.perf_counter() - t0, timer="CUDA events", card=card))
        if not (pre["fold_f32_within_test_tolerance"]
                and pre["fold_max_abs_diff"]
                <= FOLD_BF16_FACTOR * pre["bf16_rounding_max_abs_diff"]
                and all(b["pct_of_peak"] <= 100 and b["floor_ms"] <= b["ms"] for b in blocks)
                and all(r["nms_launches"] > 0 for r in flags.values())):
            raise AssertionError(f"serving_trunk_bench: {pre}, {blocks}, {flags}")

        # (c) The streamed input against its upload ceiling, and training
        # from it.
        with torch.enable_grad():
            t0 = time.perf_counter()
            stream = streaming_bench.main(["--out", os.path.join(tmp, "stream.md")])
        lines.append(dict(metric="speed_streaming", record=stream,
                          fraction_max=STREAM_FRACTION_MAX, seconds=time.perf_counter() - t0,
                          timer="host clock", card=card))
        if not (np.isfinite(stream["final_loss"])
                and stream["stream_fraction_of_ceiling"] <= STREAM_FRACTION_MAX
                and stream["train_fraction_of_ceiling"] <= STREAM_FRACTION_MAX):
            raise AssertionError(f"streaming_bench: {stream}")

        # (d) compact_pool at COCO's and VOC's class counts.
        nms_kernel.launches = 0
        t0 = time.perf_counter()
        rows = coco_decode_bench.main(["--out", os.path.join(tmp, "coco.md")])
        torch.cuda.synchronize()
        launches["speed_coco_decode"] = nms_kernel.launches
        lines.append(dict(metric="speed_coco_decode", rows=rows,
                          seconds=time.perf_counter() - t0, timer="CUDA events", card=card))
        off = next(r for r in rows if r["model"] == "coco81" and r["compact_pool"] == 0)
        if not (len(rows) == 10
                and all(np.isfinite(r["ms_per_batch"]) and r["img_per_s"] > 0 for r in rows)
                and off["nms_launches"] > 0):
            raise AssertionError(f"coco_decode_bench: {rows}")
    for line in lines:
        log(f"{line['metric']}: {json.dumps({k: v for k, v in line.items() if k != 'metric'})}")
    return lines, launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; the port's main path runs on one")
    device = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)

    # 1. Device.
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")

    # 2. Build.
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    log(f"built {build.BUILD_DIR.name}/ with nvcc in {build_s:.2f} s")
    # 3. Kernel against plain, on the card.
    max_err = nms_kernel_vs_plain(device)

    # 4. Main path.
    state = seeded_state()
    x_host = np.random.RandomState(SEED + 1).randint(0, 256, (BATCH, 300, 300, 3)).astype(np.float32)
    x = torch.from_numpy(x_host).to(device)
    f32 = model_for(state, "inference", torch.float32, device)
    bf16 = model_for(state, "inference", torch.bfloat16, device)
    fast = model_for(state, "inference_fast", torch.float32, device)

    nms_kernel.launches = 0
    det_f32 = f32(x)
    torch.cuda.synchronize()
    after_f32 = nms_kernel.launches
    det_bf16 = bf16(x)
    torch.cuda.synchronize()
    after_bf16 = nms_kernel.launches
    det_fast = fast(x)
    torch.cuda.synchronize()
    after_fast = nms_kernel.launches
    det_one = bf16(x[:1])  # batch 1: the per-class gathers come back strided
    torch.cuda.synchronize()
    main_launches = nms_kernel.launches
    log(f"main path NMS launches: f32 {after_f32}, bf16 {after_bf16 - after_f32}, "
        f"fast {after_fast - after_bf16}, bf16 batch 1 {main_launches - after_fast}")
    if not (0 < after_f32 < after_bf16 < after_fast < main_launches):
        raise AssertionError("the main path did not launch the NMS kernel in every run")

    for name, det in (("f32", det_f32), ("bf16", det_bf16), ("fast", det_fast),
                      ("bf16 batch 1", det_one)):
        det = det.cpu().numpy()
        if det.shape != (len(det), 200, 6) or len(det) not in (1, BATCH):
            raise AssertionError(f"{name}: shape {det.shape}")
        rows = det[det[..., 1] > 0]
        if len(rows) < BATCH:
            raise AssertionError(f"{name}: only {len(rows)} detections")
        check_in_frame(name, rows, 300, 300, 20)

    # Once its constants are on the card, the main path never makes the host
    # wait for the device (a blocking copy or a read of a device value).
    torch.cuda.set_sync_debug_mode("error")
    try:
        bf16(x), f32(x), fast(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("main path: no host synchronisation (torch.cuda sync debug mode 'error')")

    # f32 on the card against the same port on the CPU (plain NMS).
    cpu_det = model_for(state, "inference", torch.float32, "cpu")(torch.from_numpy(x_host))
    cpu_fast = model_for(state, "inference_fast", torch.float32, "cpu")(torch.from_numpy(x_host))
    train_cuda = model_for(state, "training", torch.float32, device)(x)
    train_cpu = model_for(state, "training", torch.float32, "cpu")(torch.from_numpy(x_host))
    y_err = float((train_cuda.cpu() - train_cpu).abs().max())
    log(f"y_pred card f32 vs CPU: max |diff| {y_err:.3g} (limit {Y_PRED_TOL})")
    if y_err > Y_PRED_TOL:
        raise AssertionError("y_pred on the card differs from the CPU")
    # The decode alone on one y_pred: the kernel path against the plain one.
    same_cuda = decode_detections_fixed(train_cuda, img_height=300, img_width=300)
    same_cpu = decode_detections_fixed(train_cuda.cpu(), img_height=300, img_width=300)
    compare_detections(
        "decode of one y_pred, card vs CPU", same_cuda.cpu().numpy(), same_cpu.numpy(), 0.0, 1e-3)
    compare_detections("inference f32, card vs CPU", det_f32.cpu().numpy(),
                       cpu_det.numpy(), SCORE_TOL, BOX_TOL)
    compare_detections("inference_fast f32, card vs CPU", det_fast.cpu().numpy(),
                       cpu_fast.numpy(), SCORE_TOL, BOX_TOL)

    # 5. Serving, through the predictor's per-shape CUDA graphs.
    serve_lines, serve_launches, graph_launches = serving_phase(bf16, state, device, card)

    # 6. Timings.
    lines = list(serve_lines)
    for dtype_name, model in (("bf16", bf16), ("f32", f32)):
        ms = summary(time_cuda(lambda: model(x), iters=20))
        lines.append(dict(
            metric="ssd300_inference_img_per_s", batch=BATCH, dtype=dtype_name,
            img_per_s=BATCH * 1e3 / ms["median"],
            img_per_s_runs=[BATCH * 1e3 / r for r in ms["runs"]],
            ms_per_batch=ms, card=card,
        ))
    lines.append(cast_ab(state, bf16, x, card))
    nms_lines = nms_timings(nms_shapes(device, bf16, x), card)
    lines += nms_lines
    nms_main = next(line for line in nms_lines if line["shape"] == "main_path")

    # 7. Training.
    with torch.enable_grad():
        train_lines = train_phase(state, device, card)
    lines += train_lines

    # 8. Data-parallel training with the on-device input pipeline.
    with torch.enable_grad():
        dp_lines, dp_launches = dp_phase(state, device, card, train_lines[0]["ms_per_step"])
    lines += dp_lines

    # 9. Evaluation: SSD512, the evaluator, the COCO tools, folding.
    eval_lines, eval_launches = eval_phase(device, card)
    lines += eval_lines

    # 10. Host-chain training.
    with torch.enable_grad():
        host_lines, host_launches = host_chain_phase(state, device, card)
    lines += host_lines

    # 11. The user workflows.
    workflow_lines, workflow_launches = workflows_phase(card)
    lines += workflow_lines

    # 12. The accuracy A/B workflows at a cut size.
    ab_lines, ab_launches = ab_workflows_phase(card)
    lines += ab_lines

    # 13. The speed and profiling workflows at their default sizes.
    speed_lines, speed_launches = speed_workflows_phase(card)
    lines += speed_lines

    for line in lines:
        print(json.dumps(line), flush=True)

    kernels = [dict(
        name="greedy_nms", route="cuda", source="ssd_keras_torch/csrc/nms.cu",
        replaces="ssd_keras_tpu/kernels/nms_pallas.py:52", launches=main_launches,
        max_abs_err=max_err, ms=nms_main["kernel_ms"]["median"],
        plain_ms=nms_main["plain_ms"]["median"], bound_ms=nms_main["bound_ms"],
        bound_by=nms_main["bound_by"], library_ms=None, library_note=NMS_LIBRARY_NOTE,
        shape="main_path", passes=2,
        launches_by_path=dict(serving=main_launches, serving_requests=serve_launches,
                              **graph_launches,
                              **dp_launches, **eval_launches, host_chain=host_launches,
                              **workflow_launches, **ab_launches, **speed_launches),
    )]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
