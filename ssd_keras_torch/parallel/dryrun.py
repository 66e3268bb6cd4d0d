"""The data-parallel training path, run end to end over several ranks.

Port of ``__graft_entry__.py:dryrun_multichip`` and the rank side of the
data-parallel checks:

* :func:`dryrun_multichip` runs, on SSD7 at 64x64 with 3 classes, the four
  stages of the JAX function: a data-parallel train step; a resident uint8
  dataset sharded over the ranks, then gather (rows exchanged between
  ranks) -> augment -> encode -> step; ``StreamingDeviceInput`` -> step;
  and the per-rank ``inference`` decode gathered into the global batch. It
  spawns gloo ranks on the CPU, or runs on the ranks of a process group
  already joined.
* :func:`dp_check_rank` is one rank of a comparison with a single process:
  one data-parallel step from given weights on given global batches, and
  optionally a per-rank decode, the hard-negative mask and the row
  exchange, returned for the caller to hold against one process.

Both are module-level functions of a module that imports no JAX, so
spawned ranks start quickly and run where JAX is not installed.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ssd_keras_torch import train as T
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.data.device_aug import DeviceSSDAugmentation
from ssd_keras_torch.data.streaming import StreamingDeviceInput
from ssd_keras_torch.decoder import decode_detections_fixed
from ssd_keras_torch.encoder import SSDInputEncoder
from ssd_keras_torch.loss import SSDLoss, hard_negative_mask
from ssd_keras_torch.models import ssd_7, ssd_300
from ssd_keras_torch.parallel.launch import run_ranks
from ssd_keras_torch.parallel.sharding import (
    exchange_rows,
    global_batch_from_local,
    make_mesh,
    replicate,
    shard_batch,
    shard_rows,
    upload_sharded,
)
from ssd_keras_torch.utils.profiling import counters

__all__ = ["dryrun_multichip", "dp_check_rank"]

_BUILDERS = {"ssd7": (ssd_7, SSDConfig.ssd7), "ssd300": (ssd_300, SSDConfig.ssd300)}


def _finite(name: str, value: torch.Tensor) -> float:
    value = float(value)
    if not math.isfinite(value):
        raise AssertionError(f"non-finite {name} {value} in the data-parallel dry run")
    return value


def _dryrun_rank(rank: int, device_type: str = "cpu") -> Dict[str, Any]:
    """One rank of :func:`dryrun_multichip`; returns its losses, the
    gathered detections' shape and its NMS kernel launches."""
    device = torch.device(device_type, torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    mesh = make_mesh(device_type)
    world = mesh.size()
    cfg = SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64)
    model, sizes = ssd_7(cfg, device=device, generator=torch.Generator().manual_seed(0))
    replicate(model, mesh)
    opt = T.sgd_with_momentum(model.parameters(), 1e-3)
    step = T.make_train_step(model, opt, SSDLoss(), l2_reg=5e-4, mesh=mesh)

    # 1. One data-parallel step on a global batch of two rows per rank.
    batch = 2 * world
    rng = np.random.RandomState(0)
    images = (rng.rand(batch, 64, 64, 3) * 255).astype(np.float32)
    n_boxes = cfg.total_boxes(sizes)
    n_cls = cfg.n_classes_with_background
    y_true = np.zeros((batch, n_boxes, n_cls + 12), np.float32)
    y_true[:, :, 0] = 1.0
    for b in range(batch):
        y_true[b, 11 * b % n_boxes, 0] = 0.0
        y_true[b, 11 * b % n_boxes, 1 + b % 3] = 1.0
    x, y = shard_batch((images, y_true), mesh, device)
    loss = _finite("loss", step(x, y)["loss"])

    # 2. A resident uint8 dataset sharded over the ranks: gather rows of a
    # global permutation (exchanged between ranks) -> augment -> encode -> step.
    max_gt = 8
    n_data = 4 * batch
    u8 = rng.randint(0, 256, (n_data, 64, 64, 3)).astype(np.uint8)
    padded = np.zeros((n_data, max_gt, 5), np.float32)
    counts = rng.randint(1, max_gt, (n_data,)).astype(np.int32)
    for b in range(n_data):
        for m in range(counts[b]):
            x0, y0 = rng.randint(0, 48, 2)
            padded[b, m] = (rng.randint(1, 4), x0, y0,
                            x0 + rng.randint(8, 16), y0 + rng.randint(8, 16))
    resident = [upload_sharded(a, mesh, device) for a in (u8, padded, counts)]
    aug = DeviceSSDAugmentation(64, 64, mesh=mesh)
    enc = SSDInputEncoder(cfg, sizes, max_gt_boxes=max_gt, device=device)
    index = rng.permutation(n_data)[:batch]
    a_imgs, a_lbls, a_counts = aug(1, *exchange_rows(resident, index, mesh))
    y_enc = enc.encode_padded(a_lbls, a_counts)
    local = batch // world
    if a_imgs.shape != (local, 64, 64, 3) or y_enc.shape != (local, n_boxes, n_cls + 12):
        raise AssertionError(f"rank {rank}: pipeline batch {tuple(a_imgs.shape)}, "
                             f"targets {tuple(y_enc.shape)}")
    loss2 = _finite("loss of the resident pipeline", step(a_imgs, y_enc)["loss"])

    # 3. Streamed: each rank uploads its rows of each global batch.
    def host_batches(n):
        for i in range(n):
            sl = slice((i % 4) * batch, (i % 4) * batch + batch)
            rows = shard_rows(batch, mesh)
            yield u8[sl][rows], padded[sl][rows], counts[sl][rows]

    loss3, n_streamed = None, 0
    for s_imgs, s_y in StreamingDeviceInput(host_batches(3), aug, enc, seed=2, n_workers=1):
        loss3 = _finite("loss of the streamed pipeline", step(s_imgs, s_y)["loss"])
        n_streamed += 1
    if n_streamed != 3:
        raise AssertionError(f"rank {rank}: the stream yielded {n_streamed} of 3 batches")

    # 4. 'inference' mode: each rank decodes its rows; the detections gathered.
    inf, _ = ssd_7(cfg, mode="inference", device=device)
    inf.load_state_dict(model.state_dict())
    before = counters().get("nms.launches", 0)
    with torch.no_grad():
        dets = global_batch_from_local(inf(x), mesh)
    if dets.shape != (batch, cfg.top_k, 6) or not bool(torch.isfinite(dets).all()):
        raise AssertionError(f"rank {rank}: gathered detections {tuple(dets.shape)}, "
                             "or non-finite")
    return dict(rank=rank, world=world, loss=loss, loss_resident=loss2, loss_streamed=loss3,
                n_streamed=n_streamed, detections=tuple(dets.shape),
                nms_launches=counters().get("nms.launches", 0) - before)


def dryrun_multichip(n_ranks: int = 2, device_type: str = "cpu", timeout: float = 300.0):
    """Run the data-parallel training path over ``n_ranks`` ranks (see the
    module docstring) and return each rank's report, in rank order.

    With a process group already joined, it runs on those ranks (there
    must be ``n_ranks``) and returns this rank's report alone. Otherwise it
    spawns ``n_ranks`` gloo ranks on ``device_type`` with a time limit of
    ``timeout`` seconds. Every rank must report the same losses.
    """
    if dist.is_initialized():
        if dist.get_world_size() != n_ranks:
            raise ValueError(f"dryrun_multichip({n_ranks}) in a group of "
                             f"{dist.get_world_size()} ranks")
        return [_dryrun_rank(dist.get_rank(), device_type)]
    reports = run_ranks(_dryrun_rank, n_ranks, (device_type,), timeout=timeout)
    keys = ("loss", "loss_resident", "loss_streamed")
    if any(tuple(r[k] for k in keys) != tuple(reports[0][k] for k in keys) for r in reports):
        raise AssertionError(f"the ranks report different losses: {reports}")
    return reports


def dp_check_rank(rank: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """One rank of a data-parallel run held against a single process.

    ``spec`` (host values only):

    * ``arch`` ("ssd7" or "ssd300"), ``config`` (keyword arguments of its
      ``SSDConfig`` constructor), ``state`` (a state dict of numpy arrays),
      ``device`` ("cpu" or "cuda");
    * ``images``, ``y_true``: one global batch; one SGD step (momentum 0.9,
      ``lr``, ``l2``, optional ``clipnorm``) in f32 with TF32 off;
    * optional ``decode``: "model" decodes the rank's images in
      'inference' mode with the weights of ``state``; "y_pred" decodes the
      rank's rows of ``y_pred`` (a global batch) with ``decode_kw``;
    * optional ``neg_losses`` (B, N) and ``n_positive`` (B,): the
      hard-negative mask of the rank's rows over the global batch;
    * optional ``dataset`` and ``index``: the resident-gather exchange.

    Returns the global metrics, the stepped state, and the gathered
    detections, mask and rows, each in global batch order.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device_type = spec["device"]
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    mesh = make_mesh(device_type)
    group = mesh.get_group("data")
    build, make_config = _BUILDERS[spec["arch"]]
    cfg = make_config(**spec["config"])
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in spec["state"].items()}

    model, _ = build(cfg, device=device)
    model.load_state_dict(state)
    opt = T.sgd_with_momentum(model.parameters(), spec["lr"], 0.9, clipnorm=spec.get("clipnorm"))
    step = T.make_train_step(model, opt, SSDLoss(), l2_reg=spec["l2"], mesh=mesh)
    x, y = shard_batch((spec["images"], spec["y_true"]), mesh, device)
    metrics = step(x, y)
    out: Dict[str, Any] = dict(
        rank=rank, loss=float(metrics["loss"]), data_loss=float(metrics["data_loss"]),
        state={k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})

    decode: Optional[str] = spec.get("decode")
    if decode is not None:
        before = counters().get("nms.launches", 0)
        with torch.no_grad():
            if decode == "model":
                inf, _ = build(cfg, mode="inference", device=device)
                inf.load_state_dict(state)
                local = inf(x)
            else:
                (y_pred,) = shard_batch((spec["y_pred"],), mesh, device)
                local = decode_detections_fixed(y_pred, **spec.get("decode_kw", {}))
            dets = global_batch_from_local(local, mesh)
        out["nms_launches"] = counters().get("nms.launches", 0) - before
        out["detections"] = dets.cpu().numpy()

    if "neg_losses" in spec:
        neg, n_pos = shard_batch((spec["neg_losses"], spec["n_positive"]), mesh, device)
        keep, n_positive = hard_negative_mask(neg, n_pos.sum(), group=group)
        out["keep"] = global_batch_from_local(keep, mesh).cpu().numpy()
        out["n_positive"] = float(n_positive)

    if "dataset" in spec:
        shards = upload_sharded(spec["dataset"], mesh, device)
        (rows,) = exchange_rows([shards], spec["index"], mesh)
        out["rows"] = global_batch_from_local(rows, mesh).cpu().numpy()
    return out
