"""Streaming device-pipeline throughput against the uint8 upload ceiling.

Port of the JAX package's ``examples/streaming_bench.py``, with its
measurements, arguments, defaults and record keys. The streaming path
(``data/streaming.py``) exists for datasets bigger than the card's memory:
uint8 batches cross the host-to-device link every step instead of once.
Each round measures, back to back:

1. **the ceiling**: as many of the store's uint8 batches as the stream
   takes, uploaded as ``StreamingDeviceInput`` uploads them (staged into a
   fresh ring of pinned buffers, copied ``non_blocking`` on a side stream,
   the consuming stream waiting on each copy's event) and reduced on the
   card, as one chain read once at the end: the staged link's own rate for
   these frames (MB/s and img/s);
2. **the stream**: what ``StreamingDeviceInput`` delivers (upload +
   on-device augment + target encode), a device checksum chained through
   every batch and read once at the end;
3. **training from the stream**: an SSD300 bf16 train step consuming it,
   the loss read once at the end and required to be finite.

The host source is pre-generated in-RAM batches (``synth_batches``, the
JAX script's generator), which isolates the pipeline from the host's JPEG
decode. The record states which of the link, the augment + encode, or the
train step bounds the stream on this card.

Usage: python -m ssd_keras_torch.examples.streaming_bench [--rounds 4] [--batches 12]
Writes the record (markdown) to ``--out``; prints ``RESULT {json}``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ssd_keras_torch import SSDConfig, SSDInputEncoder, SSDLoss
from ssd_keras_torch import train as T
from ssd_keras_torch.data.device_aug import DeviceSSDAugmentation
from ssd_keras_torch.data.streaming import StreamingDeviceInput, _PinnedRing
from ssd_keras_torch.examples.common import add_device_args, card_line, device_of
from ssd_keras_torch.models import ssd300_predictor_sizes, ssd_300

H = W = 300
MAX_GT = 16
DEPTH = 3  # uploads in flight, as the JAX script's stream
# A fraction of the ceiling at least this large means the link sets the pace.
ON_CEILING = 0.9


def synth_batches(n_batches, batch, seed=0):
    """Pre-generated uint8 batches + padded labels, then an endless cycle."""
    rng = np.random.RandomState(seed)
    store = []
    for _ in range(n_batches):
        imgs = rng.randint(0, 256, (batch, H, W, 3), np.uint8)
        labels = np.zeros((batch, MAX_GT, 5), np.float32)
        counts = rng.randint(1, 6, (batch,)).astype(np.int32)
        for b in range(batch):
            for m in range(counts[b]):
                x0, y0 = rng.randint(0, W - 60), rng.randint(0, H - 60)
                bw, bh = rng.randint(30, 60, 2)
                labels[b, m] = (rng.randint(1, 21), x0, y0, x0 + bw, y0 + bh)
        store.append((imgs, labels, counts))
    return store


def cycle(store, n):
    for i in range(n):
        yield store[i % len(store)]


def measure_link_ceiling(store, device, n_batches, n_repeats=3):
    """Pipelined uint8 uploads of ``n_batches`` of the store's batches (as
    many as the stream takes, so both pay their fresh ring's pinned buffers
    alike), staged and copied as the stream copies them; (img/s, MB/s) of
    the best repeat."""
    batches = list(cycle(store, n_batches))
    n_imgs = sum(len(b[0]) for b in batches)
    best = None
    for _ in range(n_repeats):
        t0 = time.perf_counter()
        if device.type == "cuda":
            ring, copy = _PinnedRing(DEPTH + 2), torch.cuda.Stream(device)
            consumer = torch.cuda.current_stream(device)
            total = torch.zeros((), dtype=torch.int64, device=device)
            for imgs, _, _ in batches:
                slot, (buf,) = ring.stage([torch.from_numpy(imgs)])
                with torch.cuda.stream(copy):
                    dev = buf.to(device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(copy)
                ring.uploaded(slot, event)
                consumer.wait_event(event)
                dev.record_stream(consumer)
                total += dev.sum(dtype=torch.int64)
        else:
            total = sum(torch.from_numpy(imgs).sum(dtype=torch.int64) for imgs, _, _ in batches)
        if int(total) == 0:  # the one read: waits for the whole chain
            raise AssertionError("the uploaded batches sum to 0")
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    mb = sum(b[0].nbytes for b in batches) / 1e6
    return n_imgs / best, mb / best


def measure_stream(store, aug, enc, n_batches, batch):
    """``StreamingDeviceInput``'s delivery rate: upload + augment + encode.
    A device checksum chains through every batch; one read at the end."""
    stream = StreamingDeviceInput(cycle(store, n_batches), aug, enc, depth=DEPTH, n_workers=1)
    s = torch.zeros((), device=enc.device)
    t0 = time.perf_counter()
    n = 0
    for _, y in stream:
        s = y[..., 0].sum().float() * 0 + s
        n += 1
    float(s)  # waits for the full dependent chain
    dt = time.perf_counter() - t0
    return n * batch / dt


def make_train_consumer(device):
    """SSD300 bf16 and its train step: SGD momentum 0.9, clipnorm 5, lr
    1e-4, L2 5e-4; the seeded init."""
    model, _ = ssd_300(SSDConfig.ssd300(n_classes=20), compute_dtype=torch.bfloat16,
                       device=device, generator=torch.Generator().manual_seed(0))
    opt = T.sgd_with_momentum(model.parameters(), 1e-4, momentum=0.9, clipnorm=5.0)
    return T.make_train_step(model, opt, SSDLoss(), l2_reg=5e-4)


def measure_stream_train(store, aug, enc, n_batches, batch, train_step):
    """Steady img/s with the SSD300 bf16 train step consuming the stream."""
    stream = StreamingDeviceInput(cycle(store, n_batches), aug, enc, depth=DEPTH, n_workers=1)
    t0 = time.perf_counter()
    n = 0
    with torch.enable_grad():
        for imgs, y in stream:
            m = train_step(imgs, y)
            n += 1
    loss = float(m["loss"])  # forces the whole chain
    dt = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise AssertionError(f"streamed training: non-finite loss {loss}")
    return n * batch / dt, loss


def stream_bounds(stream_fraction, train_img_per_s, stream_img_per_s):
    """What sets the pace of the stream, and of training from it."""
    stream = "link" if stream_fraction >= ON_CEILING else "augment + encode"
    train = "train step" if train_img_per_s < ON_CEILING * stream_img_per_s else stream
    return stream, train


def write_record(path, record) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# Streaming device pipeline vs the uint8 upload ceiling\n\n")
        f.write(
            f"Card: {record['card']}. `StreamingDeviceInput` (datasets bigger "
            "than the card's memory) measured against the link's own "
            "pipelined uint8 rate for the same batches, staged through the "
            "same pinned ring and side-stream copies. Each round measures "
            "ceiling -> stream -> train back to back; the headline fractions "
            "are the medians of the rounds' fractions. The stream sits on "
            "the link when `stream_fraction_of_ceiling` is near 1; below it, "
            "the on-device augment + encode sets its pace; training from the "
            "stream is bounded by the train step when it runs under the "
            f"stream's rate (`bound_by`: {record['bound_by']}).\n\n")
        f.write("```json\n" + json.dumps(record, indent=2) + "\n```\n")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="streaming pipeline vs the upload ceiling")
    p.add_argument("--rounds", type=int, default=4,
                   help="interleaved ceiling->stream->train rounds")
    p.add_argument("--batches", type=int, default=12,
                   help="timed batches per measurement chunk")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--store", type=int, default=6,
                   help="distinct pre-generated batches cycled through")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "streaming_pipeline.md"))
    add_device_args(p, compute_dtype=None)
    args = p.parse_args(argv)
    device = device_of(args)

    store = synth_batches(args.store, args.batch)
    aug = DeviceSSDAugmentation(H, W)
    enc = SSDInputEncoder(SSDConfig.ssd300(n_classes=20), ssd300_predictor_sizes(H, W),
                          max_gt_boxes=MAX_GT, device=device)
    train_step = make_train_consumer(device)

    # One untimed warm round: the first uploads, augment + encode, and train
    # step pay their one-time costs (cuDNN plans, allocator growth) here.
    measure_link_ceiling(store, device, 2, n_repeats=1)
    measure_stream(store, aug, enc, 2, args.batch)
    measure_stream_train(store, aug, enc, 2, args.batch, train_step)

    rounds = []
    for r in range(args.rounds):
        ceiling, mbps = measure_link_ceiling(store, device, args.batches, n_repeats=1)
        stream = measure_stream(store, aug, enc, args.batches, args.batch)
        trained, loss = measure_stream_train(store, aug, enc, args.batches, args.batch,
                                             train_step)
        rounds.append({
            "link_uint8_mb_per_s": mbps,
            "ceiling_img_per_s": ceiling,
            "stream_img_per_s": stream,
            "stream_fraction": stream / ceiling,
            "train_img_per_s": trained,
            "train_fraction": trained / ceiling,
            "loss": loss,
        })
        print(f"round {r}: ceiling {ceiling:.1f} ({mbps:.1f} MB/s)  "
              f"stream {stream:.1f} ({stream / ceiling:.3f})  "
              f"train {trained:.1f} ({trained / ceiling:.3f})", flush=True)

    def med(k):
        return float(np.median([r[k] for r in rounds]))

    bound_stream, bound_train = stream_bounds(
        med("stream_fraction"), med("train_img_per_s"), med("stream_img_per_s"))
    record = {
        "card": card_line(device),
        "img_shape": f"{H}x{W}x3 uint8",
        "batch": args.batch,
        "rounds": rounds,
        "median_link_uint8_mb_per_s": med("link_uint8_mb_per_s"),
        "median_ceiling_img_per_s": med("ceiling_img_per_s"),
        "median_stream_img_per_s": med("stream_img_per_s"),
        "median_train_img_per_s": med("train_img_per_s"),
        "stream_fraction_of_ceiling": med("stream_fraction"),
        "train_fraction_of_ceiling": med("train_fraction"),
        "bound_by": {"stream": bound_stream, "train": bound_train},
        "final_loss": rounds[-1]["loss"],
    }
    write_record(args.out, record)
    print("RESULT " + json.dumps(record))
    return record


if __name__ == "__main__":
    main()
