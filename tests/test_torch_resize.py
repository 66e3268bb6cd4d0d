"""The card's resize path of the evaluator, on the CPU.

* ``ops/resize.py:resize_linear_u8`` (the plain version of
  ``csrc/resize_linear.cu``) equals ``geometric.resize_image_numpy`` in
  ``INTER_LINEAR`` bit for bit on uint8, at 3 and 1 channels, alone and in
  a packed batch of mixed shapes; its wrapper's dispatch and checks.
* ``Resize.labels_and_inverter`` gives ``Resize``'s labels and inverter.
* ``DataGenerator._generate_on_card`` (the evaluator's batch source, given
  the 'resize' chain's ``Resize``; the 'pad' chain goes to ``generate``)
  keeps a batch on the card only over lazily read JPEG files decoded on a
  CUDA ``jpeg_device``, every file one the colour kernel takes and every
  size one ``resize_image`` resizes with ``_linear``; every other batch
  takes the host chain. Here the card's decode is stood in for
  by PIL on both paths, so the two paths' batches, labels and inverters
  must be equal; the resize is the plain version, as CPU tensors take it.

The card's side is ``tests/test_torch_cuda.py``.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from ssd_keras_torch import SSDConfig, native, ssd_7
from ssd_keras_torch.data import DataGenerator
from ssd_keras_torch.data import geometric as G
from ssd_keras_torch.data.patch_sampling import RandomPadFixedAR
from ssd_keras_torch.data.photometric import ConvertTo3Channels
from ssd_keras_torch.data.validation import BoxFilter
from ssd_keras_torch.eval import Evaluator
from ssd_keras_torch.kernels import resize as resize_kernel
from ssd_keras_torch.native import jpeg
from ssd_keras_torch.ops import jpeg_color
from ssd_keras_torch.ops import resize as plain
from ssd_keras_torch.utils import profiling

torch.set_num_threads(2)

# (in_h, in_w) -> (out_h, out_w): the evaluation cell's shapes, SSD300's,
# a down-scale, 1-pixel rows and columns, odd sizes.
RESIZE_CASES = [
    ((375, 500), (512, 512)), ((500, 375), (512, 512)),
    ((333, 500), (300, 300)), ((480, 640), (300, 300)),
    ((750, 1000), (300, 300)),
    ((1, 7), (5, 9)), ((7, 1), (4, 3)), ((1, 1), (3, 3)), ((9, 13), (1, 1)), ((5, 6), (1, 17)),
    ((17, 23), (11, 29)), ((3, 5), (7, 2)), ((101, 57), (64, 64)),
]


def _pack(images, gap=0):
    """Images (H, W) gray or (H, W, 3) as the colour kernel writes them: a
    flat uint8 tensor and its layout, ``gap`` bytes between images."""
    rows, chunks, off = [], [], 0
    for image in images:
        kind = jpeg_color.KIND_GRAY if image.ndim == 2 else jpeg_color.KIND_420
        rows.append([0, 0, 0, 0, 0, image.shape[0], image.shape[1], kind, off])
        chunks += [image.reshape(-1), np.zeros(gap, np.uint8)]
        off += image.size + gap
    pixels = torch.from_numpy(np.concatenate(chunks) if chunks else np.zeros(0, np.uint8))
    layout = torch.tensor(rows, dtype=torch.int64).reshape(-1, len(jpeg_color.LAYOUT_FIELDS))
    return pixels, layout


def _image(seed, h, w, channels):
    shape = (h, w) if channels == 1 else (h, w, 3)
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def _host(image, out_h, out_w):
    """What ConvertTo3Channels then Resize make of ``image`` (NumPy)."""
    rgb = np.stack([image] * 3, -1) if image.ndim == 2 else image
    return G.resize_image_numpy(rgb, out_h, out_w, G.INTER_LINEAR)


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("src, dst", RESIZE_CASES)
def test_plain_resize_equals_resize_image_numpy(src, dst, channels):
    image = _image(sum(src) + channels, *src, channels)
    got = plain.resize_linear_u8(*_pack([image]), *dst)
    assert got.shape == (1, *dst, 3) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got[0].numpy(), _host(image, *dst))
    if channels == 1:  # the gray image alone, as resize_image takes it
        np.testing.assert_array_equal(got[0, :, :, 1].numpy(),
                                      G.resize_image_numpy(image, *dst, G.INTER_LINEAR))


@pytest.mark.parametrize("dst", [(512, 512), (300, 300), (31, 17)])
def test_plain_resize_takes_a_mixed_batch_through_the_packed_layout(dst):
    images = [_image(1, 375, 500, 3), _image(2, 500, 375, 3), _image(3, 375, 500, 1),
              _image(4, 1, 9, 3), _image(5, 33, 7, 1)]
    got = plain.resize_linear_u8(*_pack(images, gap=13), *dst)
    assert got.shape == (len(images), *dst, 3)
    for k, image in enumerate(images):
        np.testing.assert_array_equal(got[k].numpy(), _host(image, *dst))


def test_taps_are_the_linear_paths_taps():
    t = plain.taps(375, 500, 512, 300)
    x0, x1, a0, a1 = t[:4 * 300].reshape(4, 300)
    y0, y1, b0, b1 = t[4 * 300:].reshape(4, 512)
    for got, want in zip((x0, x1, a0, a1), G.linear_taps_u8(500, 300, True)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip((y0, y1, b0, b1), G.linear_taps_u8(375, 512, False)):
        np.testing.assert_array_equal(got, want)
    assert t.dtype == np.int32 and np.all(a0 + a1 == 2048) and np.all(b0 + b1 == 2048)


@pytest.mark.parametrize("src, dst, linear", [
    ((375, 500), (512, 512), True), ((512, 512), (512, 512), False),
    ((1024, 1024), (512, 512), False), ((1024, 1023), (512, 512), True),
    ((600, 600), (300, 300), False), ((1, 1), (2, 2), True),
])
def test_routes_to_linear_leaves_the_copy_and_the_2x_halving_out(src, dst, linear):
    assert G.routes_to_linear(*src, *dst) is linear


def test_wrapper_takes_cpu_tensors_to_the_plain_version_and_checks_its_inputs():
    images = [_image(7, 20, 30, 3), _image(8, 30, 20, 1)]
    pixels, layout = _pack(images)
    before = profiling.counters().get("resize_linear.launches", 0)
    got = resize_kernel.resize_linear_u8(pixels, layout, 16, 24)
    # The CPU launches nothing.
    assert profiling.counters().get("resize_linear.launches", 0) == before
    assert torch.equal(got, plain.resize_linear_u8(pixels, layout, 16, 24))
    with pytest.raises(ValueError, match="uint8"):
        resize_kernel.resize_linear_u8(pixels.to(torch.int16), layout, 16, 24)
    with pytest.raises(ValueError, match="device"):
        resize_kernel.resize_linear_u8(torch.empty(10, dtype=torch.uint8, device="meta"),
                                       layout, 16, 24)
    with pytest.raises(ValueError, match="outside"):
        plain.resize_linear_u8(pixels[:-1], layout, 16, 24)
    with pytest.raises(ValueError, match="output size"):
        plain.resize_linear_u8(pixels, layout, 0, 24)
    empty = plain.resize_linear_u8(*_pack([]), 16, 24)
    assert empty.shape == (0, 16, 24, 3)


FORMAT = {"class_id": 0, "xmin": 1, "ymin": 2, "xmax": 3, "ymax": 4}


@pytest.mark.parametrize("box_filter", [None, BoxFilter(check_overlap=False, min_area=30)])
@pytest.mark.parametrize("size", [(375, 500), (21, 13)])
def test_labels_and_inverter_give_resizes_results(size, box_filter):
    rng = np.random.RandomState(sum(size))
    labels = np.concatenate([rng.randint(1, 21, (6, 1)), rng.rand(6, 4) * 12], 1)
    labels[:, 3:5] += labels[:, 1:3]
    resize = G.Resize(64, 96, box_filter=box_filter, labels_format=FORMAT)
    image, want_labels, want_inverter = resize(_image(1, *size, 3), labels, return_inverter=True)
    got_labels, got_inverter = resize.labels_and_inverter(*size, labels)
    np.testing.assert_array_equal(got_labels, want_labels)
    preds = np.concatenate([rng.rand(5, 2), rng.rand(5, 4) * 90], 1)
    np.testing.assert_array_equal(got_inverter(preds), want_inverter(preds))
    assert resize.labels_and_inverter(*size)[0] is None
    assert resize(_image(1, *size, 3)).shape == (64, 96, 3)


# --------------------------------------------------------------------------- #
# The evaluator's batch source
# --------------------------------------------------------------------------- #

GENERATOR_RETURNS = ["processed_images", "image_ids", "evaluation-neutral",
                     "inverse_transforms", "original_labels"]


def _pil(buffer):
    with Image.open(io.BytesIO(buffer)) as img:
        return np.array(img)


def _fake_decode_jpeg_batch(buffers, n_threads=0, device=None):
    return [_pil(b) for b in buffers]


def _fake_decode_packed(buffers, device=None, accept=None):
    """``jpeg.decode_packed`` with PIL in nvJPEG's place, on the CPU."""
    images = [_pil(b) for b in buffers]
    if any(i.ndim not in (2, 3) or (i.ndim == 3 and i.shape[2] != 3) for i in images):
        return None
    if accept is not None and not all(accept(*i.shape[:2]) for i in images):
        return None
    return _pack(images)


@pytest.fixture()
def card_decode(monkeypatch):
    """Both of the card's decoders stood in for by PIL; the calls of
    ``decode_packed`` that left a batch on the card are counted."""
    calls = []

    def packed(buffers, device=None, accept=None):
        out = _fake_decode_packed(buffers, device, accept)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(native, "decode_jpeg_batch", _fake_decode_jpeg_batch)
    monkeypatch.setattr(jpeg, "decode_packed", packed)
    return calls


def _files(tmp_path, sizes, ext=".jpg", gray=()):
    files, labels = [], []
    for k, (h, w) in enumerate(sizes):
        rng = np.random.RandomState(k)
        image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        pil = Image.fromarray(image).convert("L") if k in gray else Image.fromarray(image)
        path = tmp_path / f"{k}{ext if isinstance(ext, str) else ext[k]}"
        pil.save(path, quality=90) if str(path).endswith(".jpg") else pil.save(path)
        files.append(str(path))
        box = [1 + k % 3, w * 0.1, h * 0.2, w * 0.7, h * 0.9]
        labels.append(np.array([box, [2, 0, 0, 1, 1]], np.float64))
    return files, labels


def _chain(mode="resize", size=(64, 64), **resize):
    chain = [ConvertTo3Channels()]
    if mode == "pad":
        chain.append(RandomPadFixedAR(patch_aspect_ratio=size[1] / size[0], labels_format=FORMAT))
    return chain + [G.Resize(*size, labels_format=FORMAT, **resize)]


def _batches(gen, source, chain, n, batch_size=3, returns=GENERATOR_RETURNS):
    """``n`` batches of ``gen``'s ``source``; ``_generate_on_card`` is given
    the chain's last transformation, its ``Resize``, as the evaluator does."""
    kw = dict(batch_size=batch_size, shuffle=False, transformations=chain, returns=returns,
              keep_images_without_gt=True)
    it = (gen._generate_on_card(chain[-1], **kw) if source == "_generate_on_card"
          else gen.generate(**kw))
    return [next(it) for _ in range(n)]


def _assert_same_batches(card, host, preds_shape=(4, 6)):
    for got, want in zip(card, host):
        np.testing.assert_array_equal(np.asarray(got[0]), want[0])
        assert got[1:3] == want[1:3]
        for g, w in zip(got[4], want[4]):
            np.testing.assert_array_equal(g, w)
        preds = np.random.RandomState(0).rand(*preds_shape) * 60
        for g, w in zip(got[3], want[3]):
            assert len(g) == len(w)
            for gi, wi in zip(g, w):
                np.testing.assert_array_equal(gi(preds), wi(preds))


SIZES = [(37, 50), (50, 37), (37, 50), (21, 64), (64, 21), (5, 3)]


@pytest.mark.parametrize("box_filter", [None, BoxFilter(check_overlap=False, min_area=300)])
@pytest.mark.parametrize("gray", [(), (1, 4)])
def test_card_source_keeps_the_resize_chain_on_the_card_with_the_host_chains_results(
        tmp_path, card_decode, gray, box_filter):
    """Also with a box filter on the ``Resize``: the card's labels are
    filtered as the host chain's are."""
    files, labels = _files(tmp_path, SIZES, gray=gray)
    gen = DataGenerator(filenames=files, labels=labels, image_ids=list(range(6)),
                        jpeg_device="cuda", verbose=False)
    before = profiling.counters().get("data.device_resized", 0)
    card = _batches(gen, "_generate_on_card", _chain(box_filter=box_filter), 2)
    assert card_decode == [True, True]
    assert profiling.counters()["data.device_resized"] == before + 6
    assert all(isinstance(b[0], torch.Tensor) and b[0].shape == (3, 64, 64, 3) for b in card)
    host = _batches(gen, "generate", _chain(box_filter=box_filter), 2)
    assert all(isinstance(b[0], np.ndarray) for b in host)  # generate's contract holds
    _assert_same_batches(card, host)


@pytest.mark.parametrize("case", ["cpu_decoder", "in_memory", "png", "mixed",
                                  "original_images", "no_decoder"])
def test_card_source_keeps_the_host_chain_elsewhere(tmp_path, card_decode, case):
    ext = {"png": ".png", "mixed": [".jpg", ".png", ".jpg"] * 2}.get(case, ".jpg")
    files, labels = _files(tmp_path, SIZES, ext=ext)
    kw = dict(filenames=files, labels=labels, image_ids=list(range(6)), verbose=False,
              jpeg_device={"cpu_decoder": "cpu", "no_decoder": None}.get(case, "cuda"),
              load_images_into_memory=case == "in_memory")
    returns = GENERATOR_RETURNS + (["original_images"] if case == "original_images" else [])
    before = profiling.counters().get("data.device_resized", 0)
    card = _batches(DataGenerator(**kw), "_generate_on_card", _chain(), 2, returns=returns)
    host = _batches(DataGenerator(**kw), "generate", _chain(), 2, returns=returns)
    assert card_decode == []
    assert profiling.counters().get("data.device_resized", 0) == before
    assert all(isinstance(b[0], np.ndarray) for b in card)
    _assert_same_batches(card, host)


def test_card_source_refuses_a_resize_the_kernel_does_not_do(tmp_path):
    files, labels = _files(tmp_path, SIZES[:3])
    gen = DataGenerator(filenames=files, labels=labels, jpeg_device="cuda", verbose=False)
    with pytest.raises(ValueError, match="INTER_LINEAR"):
        gen._generate_on_card(G.Resize(64, 64, interpolation_mode=G.INTER_NEAREST),
                              transformations=_chain(interpolation_mode=G.INTER_NEAREST))


def test_a_batch_the_card_cannot_resize_takes_the_host_chain_alone(tmp_path, card_decode):
    """An exact 2x reduction (``_halve``) and an image already at size stay
    on the host; the next batch goes back to the card."""
    files, labels = _files(tmp_path, [(128, 128), (37, 50), (64, 64), (37, 50), (50, 37),
                                      (9, 9)])
    gen = DataGenerator(filenames=files, labels=labels, image_ids=list(range(6)),
                        jpeg_device="cuda", verbose=False)
    card = _batches(gen, "_generate_on_card", _chain(), 2)
    assert card_decode == [False, True]
    assert isinstance(card[0][0], np.ndarray) and isinstance(card[1][0], torch.Tensor)
    _assert_same_batches(card, _batches(gen, "generate", _chain(), 2))


def test_card_source_drops_filtered_items_from_the_tensor(tmp_path, card_decode):
    """Without ``keep_images_without_gt`` an image without boxes is left out
    of the batch; the tensor keeps the rows of the others."""
    files, labels = _files(tmp_path, SIZES[:3])
    labels[1] = np.zeros((0, 5))
    gen = DataGenerator(filenames=files, labels=labels, jpeg_device="cuda", verbose=False)
    kw = dict(batch_size=3, shuffle=False, transformations=_chain(),
              returns=["processed_images", "processed_labels"])
    card = next(gen._generate_on_card(kw["transformations"][-1], **kw))
    host = next(gen.generate(**kw))
    assert card_decode == [True] and card[0].shape[0] == 2
    np.testing.assert_array_equal(card[0].numpy(), host[0])
    for g, w in zip(card[1], host[1]):
        np.testing.assert_array_equal(g, w)


def test_evaluator_takes_the_card_source_with_the_host_chains_results(tmp_path, card_decode):
    files, labels = _files(tmp_path, SIZES, gray=(2,))
    model, _ = ssd_7(SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64),
                     mode="inference", generator=torch.Generator().manual_seed(0),
                     device="cpu")
    out = {}
    for path in ("card", "host"):
        gen = DataGenerator(filenames=files, labels=labels, image_ids=list(range(6)),
                            jpeg_device="cuda", verbose=False)
        if path == "host":
            gen._generate_on_card = lambda resize, **kw: gen.generate(**kw)
        ev = Evaluator(model, 3, gen, model_mode="inference", device="cpu")
        with profiling.recording():
            mean_ap = ev(64, 64, 4, verbose=False, decoding_confidence_thresh=0.2)
            counts = profiling.counted()
            names = {s.name for s in profiling.spans()}
        out[path] = (mean_ap, ev.prediction_results, counts, names)
    assert card_decode == [True, True]
    assert out["card"][2]["data.device_resized"] == 6 and "data.device_resized" not in out["host"][2]
    assert "data.resize" in out["card"][3] and "data.resize" not in out["host"][3]
    assert out["card"][0] == out["host"][0]
    assert out["card"][1] == out["host"][1] and sum(map(len, out["card"][1])) > 0


def test_pad_mode_evaluator_keeps_the_host_chain(tmp_path, card_decode):
    """The evaluator hands only its 'resize' chain to the card source."""
    files, labels = _files(tmp_path, SIZES[:4])
    model, _ = ssd_7(SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64),
                     mode="inference", generator=torch.Generator().manual_seed(0),
                     device="cpu")
    gen = DataGenerator(filenames=files, labels=labels, jpeg_device="cuda", verbose=False)
    Evaluator(model, 3, gen, model_mode="inference", device="cpu")(
        64, 64, 2, data_generator_mode="pad", verbose=False)
    assert card_decode == []


def test_upload_batch_passes_a_tensor_on_the_device_through():
    from ssd_keras_torch.eval.evaluator import upload_batch

    x = torch.zeros(2, 4, 4, 3, dtype=torch.uint8)
    assert upload_batch(x, torch.device("cpu")) is x
    y = upload_batch(x.numpy(), torch.device("cpu"))
    assert isinstance(y, torch.Tensor) and torch.equal(x, y)
