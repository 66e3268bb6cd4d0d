"""The port's streamed input pipeline on the CPU (the pinned-buffer,
side-stream upload path runs on the card: tests/test_torch_cuda.py).

Batch ``i`` of a ``StreamingDeviceInput`` must equal the direct path,
``encode(aug(batch_seed(seed, i), batch))``, bit for bit: the same
operations on the same device. A host worker's exception reaches the
consumer, ``stop()`` joins the workers, and a pipeline whose augmentation
and encoder disagree is rejected.
"""

import time

import numpy as np
import pytest
import torch

from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.data.device_aug import DeviceSSDAugmentation, batch_seed
from ssd_keras_torch.data.prefetch import PrefetchGenerator
from ssd_keras_torch.data.streaming import StreamingDeviceInput
from ssd_keras_torch.encoder import SSDInputEncoder
from ssd_keras_torch.models import ssd7_predictor_sizes

torch.set_num_threads(2)

CFG = SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64)
MAX_GT = 6


def _host_batches(n, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        images = rng.randint(0, 256, (batch, 80, 96, 3)).astype(np.uint8)
        counts = rng.randint(1, MAX_GT + 1, batch).astype(np.int32)
        labels = np.zeros((batch, MAX_GT, 5), np.float32)
        for b in range(batch):
            for m in range(counts[b]):
                x0, y0 = rng.uniform(0, 60), rng.uniform(0, 50)
                labels[b, m] = (rng.randint(1, 4), x0, y0, x0 + rng.uniform(8, 36),
                                y0 + rng.uniform(8, 30))
        out.append((images, labels, counts))
    return out


def _pipeline():
    return (DeviceSSDAugmentation(64, 64),
            SSDInputEncoder(CFG, ssd7_predictor_sizes(64, 64), max_gt_boxes=MAX_GT, device="cpu"))


@pytest.mark.parametrize("n_workers", [1, 3])
def test_stream_equals_direct_path(n_workers):
    batches = _host_batches(5)
    aug, enc = _pipeline()
    stream = StreamingDeviceInput(iter(batches), aug, enc, seed=7, n_workers=n_workers)
    got = list(stream)
    assert len(got) == len(batches)
    for i, ((images, labels, counts), (s_images, s_y)) in enumerate(zip(batches, got)):
        d_images, d_labels, d_counts = aug(batch_seed(7, i), torch.from_numpy(images),
                                           torch.from_numpy(labels), torch.from_numpy(counts))
        assert torch.equal(s_images, d_images)
        assert torch.equal(s_y, enc.encode_padded(d_labels, d_counts))
        assert s_y.shape == (4, 340, CFG.n_classes_with_background + 12)


def test_stream_seeds_differ_per_batch():
    batch = _host_batches(1)[0]
    aug, enc = _pipeline()
    first, second = [x for x, _ in StreamingDeviceInput(iter([batch, batch]), aug, enc, seed=3)]
    assert not torch.equal(first, second)


def test_host_error_reaches_the_consumer():
    batches = _host_batches(2)

    def failing():
        yield from batches
        raise OSError("disk gone")

    aug, enc = _pipeline()
    stream = StreamingDeviceInput(failing(), aug, enc)
    seen = []
    with pytest.raises(OSError, match="disk gone"):
        for item in stream:
            seen.append(item)
    assert len(seen) <= 2
    assert stream._host.workers_alive == 0


def test_stop_joins_the_workers():
    def endless():
        batch = _host_batches(1)[0]
        while True:
            yield batch

    aug, enc = _pipeline()
    stream = StreamingDeviceInput(endless(), aug, enc, prefetch_depth=2, n_workers=2)
    it = iter(stream)
    next(it)
    next(it)
    stream.stop()
    assert stream._host.workers_alive == 0
    it.close()  # the generator's own stop finds the workers gone


def test_prefetch_stop_drains_a_full_queue_and_keeps_order():
    gen = PrefetchGenerator(iter(range(100)), buffer_size=2, n_workers=4)
    assert [next(gen) for _ in range(10)] == list(range(10))
    time.sleep(0.05)  # the workers fill the queue and block on it
    gen.stop(timeout=5.0)
    assert gen.workers_alive == 0


@pytest.mark.parametrize("case", ["size", "mesh_device"])
def test_a_mismatched_pipeline_is_rejected(case):
    aug, enc = _pipeline()
    if case == "size":
        aug = DeviceSSDAugmentation(48, 64)
        match = "64x64"
    else:
        class CudaMesh:  # a mesh on another device type than the encoder's
            device_type = "cuda"

        aug = DeviceSSDAugmentation(64, 64, mesh=CudaMesh())
        match = "mesh"
    with pytest.raises(ValueError, match=match):
        StreamingDeviceInput(iter(_host_batches(1)), aug, enc)


def _synthvoc_generators():
    """The JAX package's and the port's in-memory DataGenerators over one
    SynthVOC split of 10 images at 96x96 (a batch of 4 wraps the epoch)."""
    from ssd_keras_torch.data import SynthVOC
    from ssd_keras_torch.data.datasets import DataGenerator
    from ssd_keras_tpu.data.datasets import DataGenerator as JaxDataGenerator

    images, labels = SynthVOC(10, image_size=96, split="train", seed=4).materialize()
    gens = []
    for cls in (JaxDataGenerator, DataGenerator):
        gen = cls()
        gen.images = [images[i] for i in range(len(images))]
        gen.labels = [np.asarray(l) for l in labels]
        gen.dataset_size = len(images)
        gen.dataset_indices = np.arange(len(images), dtype=np.int32)
        gens.append(gen)
    return gens


@pytest.mark.parametrize("shuffle, shard_index, num_shards, seed",
                         [(False, 0, 1, None), (True, 0, 1, 3), (True, 1, 2, 3), (False, 2, 3, None)])
def test_host_decode_batches_equal_jax(shuffle, shard_index, num_shards, seed):
    from ssd_keras_torch.data.streaming import host_decode_batches
    from ssd_keras_tpu.data.streaming import host_decode_batches as jax_host_decode_batches

    jax_gen, port_gen = _synthvoc_generators()
    out = []
    for fn, gen in ((jax_host_decode_batches, jax_gen), (host_decode_batches, port_gen)):
        np.random.seed(9)
        stream = fn(gen, 4, 64, 80, MAX_GT, shuffle=shuffle, shard_index=shard_index,
                    num_shards=num_shards, seed=seed)
        out.append([next(stream) for _ in range(4)])
    for (ji, jp, jc), (pi, pp, pc) in zip(*out):
        assert pi.dtype == np.uint8 and pi.shape[1:] == (64, 80, 3)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pp, jp)
        np.testing.assert_array_equal(pc, jc)


def test_host_decode_batches_shards_are_disjoint_and_need_a_seed():
    from ssd_keras_torch.data.streaming import host_decode_batches

    _, gen = _synthvoc_generators()
    whole = host_decode_batches(gen, 2, 64, 64, MAX_GT, shuffle=True, seed=1)
    batches = [next(whole)[0] for _ in range(4)]
    shards = [host_decode_batches(gen, 2, 64, 64, MAX_GT, shuffle=True, shard_index=r,
                                  num_shards=2, seed=1) for r in range(2)]
    for r, shard in enumerate(shards):
        for k in range(2):
            np.testing.assert_array_equal(next(shard)[0], batches[2 * k + r])
    with pytest.raises(ValueError, match="needs a seed"):
        next(host_decode_batches(gen, 2, 64, 64, MAX_GT, shuffle=True, num_shards=2))
    with pytest.raises(ValueError, match="out of range"):
        next(host_decode_batches(gen, 2, 64, 64, MAX_GT, shard_index=2, num_shards=2))
