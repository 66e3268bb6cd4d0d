"""Streaming device input for datasets larger than device memory (PyTorch).

Port of ``ssd_keras_tpu/data/streaming.py``: :func:`host_decode_batches`
makes the host batches and :class:`StreamingDeviceInput` feeds them to the
card. The resident path uploads a decoded uint8 split once and gathers batches on the
card; this one streams host batches through a double-buffered upload into
the same augment + encode:

* host worker threads produce ``(uint8 images, padded labels, counts)``
  (:class:`~ssd_keras_torch.data.prefetch.PrefetchGenerator` keeps
  ``prefetch_depth`` ready; an exception in one reaches the consumer);
* on a CUDA device each batch is copied into a ring of pinned host buffers
  and uploaded on a side stream, ``depth`` batches ahead of the one being
  consumed; an event marks each upload, the consuming stream waits on it,
  and a pinned buffer is refilled only after its last upload's event has
  completed;
* the consuming stream runs :class:`DeviceSSDAugmentation` and
  ``SSDInputEncoder.encode_padded``, seeded per batch by
  :func:`~ssd_keras_torch.data.device_aug.batch_seed` (a host integer, so no
  batch reads the device for its seed).

Batch ``i`` of a stream equals the direct path ``encode(aug(batch_seed(seed,
i), ...))`` on the same host batch bit for bit: the same ops on the same
device. Under a data mesh each rank streams its own rows of each global
batch (:func:`host_decode_batches` with a shard index) and passes the
seed every rank shares. Pixels cross the link as uint8. All state belongs
to the stream object: no program or buffer is shared through a
process-wide cache.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Iterator, Optional

import numpy as np
import torch

from ssd_keras_torch.data.device_aug import batch_seed
from ssd_keras_torch.data.prefetch import PrefetchGenerator

__all__ = ["StreamingDeviceInput", "host_decode_batches"]


def host_decode_batches(dataset, batch_size: int, img_height: int, img_width: int,
                        max_gt_boxes: int, shuffle: bool = True, shard_index: int = 0,
                        num_shards: int = 1, seed: Optional[int] = None):
    """Endless host batches ``(uint8 images, padded labels, counts)``.

    The host's whole job per step: decode, 3-channel conversion, one
    fixed-size resize, label padding; augmentation and encoding run on the
    device. Labels are resized with the image (the device chain expects
    boxes in the resized frame, as the resident path does).

    Sharding (``shard_index`` / ``num_shards``): every rank runs the same
    generator and takes every ``num_shards``-th batch, so the ranks' local
    batches are disjoint and together form the global batch sequence. With
    ``shuffle=True`` this needs a ``seed``, so that every rank draws the same
    permutations (the generator seeds the global ``np.random``, whose
    permutations ``DataGenerator.generate`` draws).
    """
    from ssd_keras_torch.data.geometric import Resize
    from ssd_keras_torch.data.photometric import ConvertTo3Channels
    from ssd_keras_torch.encoder import pad_labels

    if not (0 <= shard_index < num_shards):
        raise ValueError(
            f"shard_index {shard_index} out of range for {num_shards} shards.")
    if num_shards > 1 and shuffle and seed is None:
        raise ValueError(
            "Sharded host_decode_batches with shuffle=True needs a seed so "
            "every process draws identical permutations (disjoint shards).")
    if seed is not None:
        np.random.seed(seed)

    gen = dataset.generate(
        batch_size=batch_size,
        shuffle=shuffle,
        transformations=[ConvertTo3Channels(), Resize(img_height, img_width)],
        label_encoder=None,
        returns=["processed_images", "processed_labels"],
        keep_images_without_gt=True,
    )
    if num_shards > 1:
        gen = itertools.islice(gen, shard_index, None, num_shards)
    for images, labels in gen:
        u8 = np.clip(np.rint(np.asarray(images)), 0, 255).astype(np.uint8)
        padded, counts = pad_labels(list(labels), max_gt_boxes, truncate=True)
        yield u8, padded, counts


class _PinnedRing:
    """``slots`` pinned host buffers per array, each with the event of its
    last upload."""

    def __init__(self, slots: int):
        self._buffers = [None] * slots
        self._events = [None] * slots
        self._next = 0

    def stage(self, arrays):
        """Copy ``arrays`` into the next slot's pinned buffers, after that
        slot's previous upload has completed. Returns (slot, the buffers)."""
        slot = self._next
        self._next = (slot + 1) % len(self._buffers)
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        bufs = self._buffers[slot]
        if bufs is None or any(b.shape != a.shape or b.dtype != a.dtype
                               for b, a in zip(bufs, arrays)):
            bufs = self._buffers[slot] = [torch.empty(a.shape, dtype=a.dtype).pin_memory()
                                          for a in arrays]
        for b, a in zip(bufs, arrays):
            b.copy_(a)
        return slot, bufs

    def uploaded(self, slot: int, event: torch.cuda.Event):
        self._events[slot] = event


class StreamingDeviceInput:
    """Double-buffered host-to-device feed for the on-device train pipeline.

    Iterating yields ``(images, y_encoded)`` on the encoder's device, ready
    for the train step.

    Parameters
    ----------
    host_batches:
        Iterator of ``(uint8 images (B, H, W, 3), padded labels (B, M, 5),
        counts (B,))`` host arrays. Under a mesh: the rank's rows of each
        global batch.
    device_aug, encoder:
        A ``DeviceSSDAugmentation`` whose output size is the encoder's
        image size; the stream runs on the encoder's device and the
        augmentation's mesh.
    seed:
        The run's augmentation seed; batch ``i`` draws with
        ``batch_seed(seed, i)``. Every rank passes the same one.
    depth:
        Uploads in flight beyond the batch being consumed (2: double
        buffering).
    prefetch_depth, n_workers:
        The host queue's depth and its worker threads.
    """

    def __init__(self, host_batches: Iterator, device_aug, encoder, seed: int = 0,
                 depth: int = 2, prefetch_depth: int = 4, n_workers: int = 2):
        cfg = encoder.config
        if (device_aug.out_h, device_aug.out_w) != (cfg.img_height, cfg.img_width):
            raise ValueError(
                f"device_aug makes {device_aug.out_h}x{device_aug.out_w} images but the "
                f"encoder's model takes {cfg.img_height}x{cfg.img_width}")
        self.device = encoder.device
        mesh = device_aug.mesh
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"device_aug's mesh is on {mesh.device_type} devices but the encoder "
                f"encodes on {self.device}")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._aug = device_aug
        self._encoder = encoder
        self._seed = int(seed)
        self._index = 0
        self._depth = max(1, int(depth))
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            # One slot per batch in flight, one being consumed, one being staged.
            self._ring = _PinnedRing(self._depth + 2)
        self._host = PrefetchGenerator(host_batches, buffer_size=prefetch_depth,
                                       n_workers=n_workers)

    def _upload(self, item):
        """Start one batch's upload; returns what ``_finish`` takes."""
        arrays = (np.ascontiguousarray(item[0], dtype=np.uint8),
                  np.asarray(item[1], dtype=np.float32),
                  np.asarray(item[2], dtype=np.int32))
        seed = batch_seed(self._seed, self._index)
        self._index += 1
        if not self._cuda:
            return seed, tuple(torch.from_numpy(a).to(self.device) for a in arrays), None
        slot, bufs = self._ring.stage([torch.from_numpy(a) for a in arrays])
        with torch.cuda.stream(self._copy_stream):
            dev = tuple(b.to(self.device, non_blocking=True) for b in bufs)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        self._ring.uploaded(slot, event)
        return seed, dev, event

    def _finish(self, pending):
        """Augment and encode one uploaded batch on the current stream."""
        seed, (imgs, lbls, cnts), event = pending
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in (imgs, lbls, cnts):
                # Allocated on the copy stream, used and freed on this one.
                t.record_stream(stream)
        aug_imgs, aug_lbls, aug_cnts = self._aug(seed, imgs, lbls, cnts)
        return aug_imgs, self._encoder.encode_padded(aug_lbls, aug_cnts)

    def __iter__(self):
        pending = deque()
        try:
            for item in self._host:
                pending.append(self._upload(item))
                if len(pending) > self._depth:
                    yield self._finish(pending.popleft())
            while pending:
                yield self._finish(pending.popleft())
        finally:
            self._host.stop()

    def stop(self):
        """Stop and join the host workers."""
        self._host.stop()
