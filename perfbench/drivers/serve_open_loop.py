"""Open-loop serving through ``SSDPredictor.predict``.

Set-up: the seeded weights, the port's 'inference' model and its
predictor, a pool of images of each of the cell's shapes, and one batch of
each shape through ``predict``, which captures that shape's CUDA graph.
Window: the requests of ``traffic.open_loop`` at their due times, served
first in, first out by one worker; each is timed from when it was due to
its detections on the host, so a request that waits behind another counts
the wait. Below the knee (the cell's ``close`` is ``"served"``) every
request due in the window is served and the window closes when the last
is; ``request_p95_ms`` is the 95th percentile (nearest rank) over all of
them, a failed request counting as infinitely late. Above the knee
(``close`` is ``"seconds"``) the backlog grows all through the run: the
window closes after ``--seconds``, requests not begun by then are not
attempted, and ``served_img_per_s`` is the images of the requests served
over the window's time. The run reports those of its end-to-end metrics
that the manifest names for the cell.

Check: once the window has closed, a sample of the served requests drawn
from the seed, a third of it from those with the most images, is run
again through the plain reference in float32 (resize, forward, decode with
NMS, the rescale to each image's frame), and each image's detections are
judged by ``reference.compare.gaps``; the worst of each gap over the
sample is compared with its limit in the cell's file.
"""

from __future__ import annotations

import gc
import math
import sys
import time
import traceback

import numpy as np
import torch

from perfbench import harness, port, traffic, weights
from perfbench.reference import compare, decode, ssd


def reference_detections(config: dict, params: dict, batch: torch.Tensor, anchors: torch.Tensor,
                         quantize=None):
    """The reference's scores (B, N, C), corners (B, N, 4), detections
    (B, top_k, 6) and their margins (B, top_k) in the frame of the uint8
    images ``batch`` (B, h, w, 3)."""
    h, w = config["img_height"], config["img_width"]
    ih, iw = batch.shape[1:3]
    x = batch.float() if (ih, iw) == (h, w) else ssd.resize_antialiased(batch, h, w)
    scores, offsets = ssd.forward(config, params, x, quantize=quantize)
    corners = ssd.decode_boxes(config, offsets, anchors)
    out = decode.decode(scores, corners, config["confidence_thresh"], config["iou_threshold"],
                        config["top_k"], config["nms_max_output_size"])
    scale = torch.tensor([iw / w, ih / h, iw / w, ih / h], device=batch.device)
    dets = out["detections"].clone()
    dets[..., 2:6] *= scale
    return scores, corners * scale, dets, out["margin"]


def judge(config: dict, params: dict, batches, served) -> dict:
    """The worst gaps over ``batches`` (uint8 image tensors) whose
    detections the program returned as ``served`` (per batch, per image,
    rows [class, score, x1, y1, x2, y2] in the image's frame)."""
    anchors = torch.from_numpy(ssd.anchors(config)).float().to(batches[0].device)
    worst = dict(served_gap=0.0, missed_gap=0.0)
    for batch, dets in zip(batches, served):
        with torch.no_grad():
            scores, corners, ref, margin = reference_detections(config, params, batch, anchors)
        for j, d in enumerate(dets):
            d = torch.as_tensor(np.asarray(d), dtype=torch.float32, device=batch.device)
            real = ref[j, :, 0] != 0
            s, m = compare.gaps(d, scores[j], corners[j], ref[j][real], margin[j][real])
            worst["served_gap"] = max(worst["served_gap"], s)
            worst["missed_gap"] = max(worst["missed_gap"], m)
    return worst


def batch_of(pools, request, device) -> torch.Tensor:
    """A request's images as one uint8 (k, h, w, 3) batch on ``device``."""
    return torch.from_numpy(np.stack([pools[request.shape][j] for j in request.images])).to(device)


def sample(schedule, seed: int, n: int):
    longest = max(len(r.images) for r in schedule)
    return traffic.balanced_sample(traffic.rng(seed, 4), len(schedule), n,
                                   [i for i, r in enumerate(schedule) if len(r.images) == longest])


def serve(run: harness.Run, predictor, pools, schedule, close_after=math.inf):
    """The open loop: each request at its due time, first in, first out,
    none begun ``close_after`` seconds or more after the window opened.
    Returns the latency of each request begun (inf where it failed), the
    detections of each served one, how late the worker woke where it
    waited, and the window's length."""
    p = run.cell["traffic"]
    served = {}
    latency = []
    late = []
    prof, trace_from, trace_to = None, p["trace_from_s"], math.inf
    t0 = time.perf_counter()
    for i, req in enumerate(schedule):
        due = t0 + req.due
        now = time.perf_counter()
        if max(now, due) - t0 >= close_after:
            break
        latency.append(math.inf)
        if now < due:
            with run.span("wait_arrival"):
                time.sleep(due - now)
            late.append(time.perf_counter() - due)
        if run.trace and prof is None and run.traced is None and now - t0 >= trace_from:
            prof = run.profiler()
            trace_to = time.perf_counter() - t0 + p["trace_s"]
        elif prof is not None and now - t0 >= trace_to:
            run.stop_profiler(prof)
            prof = None
        images = [pools[req.shape][j] for j in req.images]
        try:
            with run.span("predict"):
                dets = predictor.predict(images)
        except Exception:  # a failed request counts as missing; the run goes on
            traceback.print_exc()
            run.failed += 1
            continue
        latency[i] = time.perf_counter() - due
        served[i] = dets
    if prof is not None:
        run.stop_profiler(prof)
    return latency, served, late, time.perf_counter() - t0


def percentile(latency, q: float) -> float:
    """The ``q``-th percentile by nearest rank."""
    ranked = sorted(latency)
    return ranked[math.ceil(q / 100 * len(ranked)) - 1]


def run(run: harness.Run) -> None:
    from ssd_keras_torch.predictor import SSDPredictor

    cell, config, p = run.cell, run.config, run.cell["traffic"]
    device = run.device
    params = weights.seeded(config, run.seed, device)
    model = port.model(config, "inference", params, device)
    predictor = SSDPredictor(model, batch_size=cell["batch_size"])
    pools = traffic.image_pool(p, run.seed, device)
    schedule = traffic.open_loop(p, run.seed, run.seconds)
    for pool in pools:
        predictor.predict(list(pool[: cell["batch_size"]]))
    run.warm_profiler()
    harness.synchronize(device)
    run.setup_done()

    close_after = run.seconds if p["close"] == "seconds" else math.inf
    latency, served, late, window = serve(run, predictor, pools, schedule, close_after)

    begun = schedule[: len(latency)]
    images = sum(len(r.images) for r, t in zip(begun, latency) if math.isfinite(t))
    run.attempted = len(begun)
    run.e2e.update(request_p95_ms=1e3 * percentile(latency, 95),
                   served_img_per_s=images / window)
    run.values.update(window_s=window, requests=len(begun), images=images)
    if run.traced is not None:  # the readers' rate leaves out the profiler's time
        lo, cost = run.traced["host_begin"], run.traced["host_cost_s"]
        inside = sum(len(schedule[i].images) for i, (a, _) in zip(served, run.spans["predict"])
                     if lo <= a < lo + cost)
        run.values.update(window_s=window - cost, images=images - inside)
    if late:
        print(f"generator: {len(late)} of {len(schedule)} requests found the worker idle; "
              f"it woke {1e3 * float(np.median(late)):.3f} ms late at the median, "
              f"{1e3 * max(late):.3f} ms at most", file=sys.stderr)
    half = len(latency) // 2
    if half:
        print(f"latency p95 over the first half of the requests "
              f"{1e3 * percentile(latency[:half], 95):.3f} ms, over the second "
              f"{1e3 * percentile(latency[half:], 95):.3f} ms", file=sys.stderr)
    service = sorted(b - a for a, b in run.spans["predict"])
    if service:
        print(f"service: median {1e3 * service[len(service) // 2]:.3f} ms, p99 "
              f"{1e3 * service[int(0.99 * (len(service) - 1))]:.3f} ms, max "
              f"{1e3 * service[-1]:.3f} ms; {sum(t > 0.02 for t in service)} over 20 ms",
              file=sys.stderr)

    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    del predictor, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ssd.exact_float32()
    checked = sample(begun, run.seed, cell["check"]["requests"])
    came = [i for i in checked if i in served]
    worst = judge(config, params, [batch_of(pools, schedule[i], device) for i in came],
                  [served[i] for i in came])
    if any(i not in served for i in checked):
        worst["served_gap"] = math.inf  # a sampled request never came
    for name, limit in cell["check"]["limits"].items():
        run.check(name, worst[name], limit)


def control(run: harness.Run, quantize) -> dict:
    """The check's numbers with the reference computed in ``quantize`` in
    the program's place, on the requests a run of this seed would sample."""
    config, p, device = run.config, run.cell["traffic"], run.device
    params = weights.seeded(config, run.seed, device)
    pools = traffic.image_pool(p, run.seed, device)
    schedule = traffic.open_loop(p, run.seed, run.seconds)
    anchors = torch.from_numpy(ssd.anchors(config)).float().to(device)
    ssd.exact_float32()
    batches, served = [], []
    for i in sample(schedule, run.seed, run.cell["check"]["requests"]):
        batch = batch_of(pools, schedule[i], device)
        with torch.no_grad():
            dets = reference_detections(config, params, batch, anchors, quantize)[2]
        batches.append(batch)
        served.append([d[d[:, 0] != 0].cpu().numpy() for d in dets])
    return judge(config, params, batches, served)
