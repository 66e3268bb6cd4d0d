"""The whole SSD300 serving slice: the port against the JAX package.

Weights: flax ``init`` -> ``from_flax_params`` -> the port, with conv1_1
scaled by 1/100 on both sides so scores and offsets lie in a trained
detector's range (see tests/test_torch_models.py). Images are numpy arrays
from a seed. Both sides run ``inference`` mode end to end on the CPU: the
JAX model with its default CPU NMS (the fixpoint, bit-identical to the
scan), the port with its plain PyTorch NMS.
"""

import jax
import numpy as np
import pytest
import torch

from ssd_keras_tpu import weights_io as jax_weights_io
from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.models import ssd_300 as jax_ssd_300
from ssd_keras_tpu.predictor import device_resize_batch as jax_resize
from ssd_keras_torch import SSDConfig, SSDPredictor, from_flax_params, load_keras_h5_weights, ssd_300
from ssd_keras_torch.predictor import device_resize_batch, resize_bilinear_pil
from ssd_keras_torch.utils import profiling
from ssd_keras_tpu.predictor import SSDPredictor as JaxSSDPredictor

torch.set_num_threads(2)

# Detection tolerances. The trunk's y_pred differs between XLA and PyTorch
# by convolution summation order (~1e-5 relative, tests/test_torch_models.py);
# through the decode that is <= 4e-6 on a score and <= 5e-4 px on a box
# coordinate. The limits sit a few times above that. A row whose NMS or
# threshold decision flipped would be missing from one side altogether.
SCORE_TOL = 1e-5
BOX_TOL = 2e-3


@pytest.fixture(scope="module")
def shared():
    """(flax inference model, flax params with conv1_1 scaled, 2 images)."""
    model, _ = jax_ssd_300(JaxSSDConfig.ssd300(n_classes=20), mode="inference")
    x = np.random.RandomState(2).rand(2, 300, 300, 3).astype(np.float32) * 255
    variables = model.init(jax.random.PRNGKey(0), x[:1])
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    params["conv1_1"]["kernel"] = params["conv1_1"]["kernel"] / 100.0
    return model, params, x


def _port_model(params, mode="inference"):
    model, _ = ssd_300(SSDConfig.ssd300(n_classes=20), mode=mode, device="cpu")
    model.load_state_dict(from_flax_params(params))
    return model


def _mismatch_report(got, expected, cut):
    """Match rows (class, score, box) one to one; describe what is left."""
    unmatched = list(range(len(expected)))
    free = list(range(len(got)))
    for i in list(unmatched):
        for j in free:
            if (got[j, 0] == expected[i, 0]
                    and abs(got[j, 1] - expected[i, 1]) <= SCORE_TOL
                    and np.all(np.abs(got[j, 2:] - expected[i, 2:]) <= BOX_TOL)):
                unmatched.remove(i)
                free.remove(j)
                break
    lines = []
    for side, rows, idx in (("JAX only", expected, unmatched), ("port only", got, free)):
        for i in idx:
            kind = ("top-k cut flip" if abs(rows[i, 1] - cut) <= SCORE_TOL
                    else "confidence or IoU threshold flip, or a wrong value")
            lines.append(f"{side}: row {i} {rows[i].tolist()} ({kind})")
    return lines


def test_inference_slice_matches_jax(shared):
    flax_model, params, x = shared
    expected = np.asarray(flax_model.apply({"params": params}, x))
    with torch.no_grad():
        got = _port_model(params)(torch.from_numpy(x)).numpy()
    assert got.shape == expected.shape == (2, 200, 6)
    for b in range(2):
        exp_b = expected[b][expected[b, :, 1] > 0]
        got_b = got[b][got[b, :, 1] > 0]
        assert len(exp_b) > 100
        report = _mismatch_report(got_b, exp_b, cut=exp_b[-1, 1])
        assert not report, f"image {b}:\n" + "\n".join(report)


def test_h5_written_by_jax_loads_into_port(shared, tmp_path):
    """``save_keras_h5_weights`` (JAX) -> ``load_keras_h5_weights`` (port):
    every SSD300 layer loads, and y_pred equals the ``from_flax_params``
    model's bit for bit."""
    _, params, x = shared
    path = str(tmp_path / "ssd300.h5")
    jax_weights_io.save_keras_h5_weights(path, params)
    model, _ = ssd_300(SSDConfig.ssd300(n_classes=20), mode="training",
                       generator=torch.Generator().manual_seed(3), device="cpu")
    loaded = load_keras_h5_weights(path, model, on_unconsumed="raise")
    assert sorted(loaded) == sorted(params) and len(loaded) == 36
    reference = _port_model(params, mode="training")
    with torch.no_grad():
        a = model(torch.from_numpy(x[:1]))
        b = reference(torch.from_numpy(x[:1]))
    assert torch.equal(a, b)


@pytest.mark.parametrize("in_hw", [(480, 640), (200, 250)])
def test_device_resize_matches_jax(in_hw):
    """Shrinking and growing a uint8 batch; 2e-3 on a 0-255 scale covers the
    two libraries' f32 filter-weight arithmetic."""
    img = np.random.RandomState(4).randint(0, 256, (2, *in_hw, 3), dtype=np.uint8)
    expected = np.asarray(jax_resize(img, 300, 300))
    got = device_resize_batch(torch.from_numpy(img), 300, 300).numpy()
    assert got.shape == (2, 300, 300, 3)
    np.testing.assert_allclose(got, expected, rtol=0, atol=2e-3)


def test_predictor_answers_requests(shared):
    """Three requests on the CPU: model-size frames, 480x640 frames, and a
    partial batch. Boxes come back in each image's own frame."""
    _, params, _ = shared
    model = _port_model(params)
    predictor = SSDPredictor(model, batch_size=2)
    rng = np.random.RandomState(5)
    small = [rng.randint(0, 256, (300, 300, 3), dtype=np.uint8) for _ in range(2)]
    large = [rng.randint(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(2)]
    launches = profiling.counters().get("nms.launches", 0)

    out_small = predictor.predict(small)
    with torch.no_grad():
        direct = model(torch.from_numpy(np.stack(small)).float()).numpy()
    for dets, ref in zip(out_small, direct):
        np.testing.assert_array_equal(dets, ref[ref[:, 0] != 0])

    out_large = predictor.predict(large)
    with torch.no_grad():
        resized = device_resize_batch(torch.from_numpy(np.stack(large)), 300, 300)
        direct = model(resized).numpy()
    for dets, ref in zip(out_large, direct):
        ref = ref[ref[:, 0] != 0].copy()
        ref[:, [2, 4]] *= 640 / 300
        ref[:, [3, 5]] *= 480 / 300
        np.testing.assert_allclose(dets, ref, rtol=1e-6)

    out_one = predictor.predict(large[:1])  # padded to the batch size
    np.testing.assert_array_equal(out_one[0], out_large[0])
    for dets in out_small + out_large:
        assert dets.shape[1] == 6 and len(dets) > 0 and np.isfinite(dets).all()
    # CPU tensors never launch the kernel.
    assert profiling.counters().get("nms.launches", 0) == launches


def test_predictor_host_resize_and_filter(shared):
    """The host paths (a grayscale frame made RGB; ``resize_on_device=False``,
    PIL's bilinear resize in NumPy), held against PIL, and the
    ``confidence_thresh`` post-filter."""
    from PIL import Image

    _, params, _ = shared
    model = _port_model(params)
    rng = np.random.RandomState(6)
    gray = rng.randint(0, 256, (300, 300), dtype=np.uint8)
    frame = rng.randint(0, 256, (480, 640, 3), dtype=np.uint8)

    def direct(image_hwc):
        with torch.no_grad():
            dets = model(torch.from_numpy(np.asarray(image_hwc, np.float32))[None]).numpy()[0]
        return dets[dets[:, 0] != 0]

    out_gray = SSDPredictor(model, batch_size=1).predict([gray])[0]
    np.testing.assert_array_equal(out_gray, direct(Image.fromarray(gray).convert("RGB")))

    host = SSDPredictor(model, batch_size=1, resize_on_device=False)
    out_host = host.predict([frame])[0]
    expected = direct(Image.fromarray(frame).resize((300, 300), Image.BILINEAR))
    expected[:, [2, 4]] *= 640 / 300
    expected[:, [3, 5]] *= 480 / 300
    np.testing.assert_allclose(out_host, expected, rtol=1e-6)

    filtered = SSDPredictor(model, batch_size=1, confidence_thresh=0.7).predict([gray])[0]
    np.testing.assert_array_equal(filtered, out_gray[out_gray[:, 1] > 0.7])
    assert 0 < len(filtered) < len(out_gray)


def test_predictor_rejects_training_model():
    model, _ = ssd_300(SSDConfig.ssd300(n_classes=4), mode="training", device="cpu")
    with pytest.raises(ValueError, match="inference"):
        SSDPredictor(model)


@pytest.mark.parametrize("in_hw, out_hw", [((480, 640), (300, 300)), ((200, 250), (300, 300)),
                                           ((300, 300), (512, 512)), ((97, 1000), (300, 300)),
                                           ((301, 299), (150, 600))])
def test_resize_bilinear_pil_matches_pil(in_hw, out_hw):
    """PIL's ``Image.BILINEAR`` in NumPy, sizes up and down: within one
    level and equal on at least 99% of pixels (it is equal on all of them
    with the Pillow the tests ran against)."""
    from PIL import Image

    img = np.random.RandomState(7).randint(0, 256, (*in_hw, 3), dtype=np.uint8)
    expected = np.asarray(Image.fromarray(img).resize(out_hw[::-1], Image.BILINEAR))
    got = resize_bilinear_pil(img, *out_hw)
    assert got.shape == expected.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - expected.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def _gray_and_rgba(rng, hw):
    gray = rng.randint(0, 256, hw, dtype=np.uint8)
    rgba = rng.randint(0, 256, (*hw, 4), dtype=np.uint8)
    return {"gray": gray, "rgba": rgba}


def test_predictor_gray_and_rgba_match_jax(shared):
    """Gray and RGBA frames through the port's predictor (no PIL) against the
    JAX predictor (PIL) on the CPU: at the model's size with
    ``resize_on_device=True`` and at 240x320 with ``False`` (both sides then
    resize with PIL's bilinear filter). At 240x320 with ``True`` the port
    takes the RGB-converted frame down the device resize, as for an RGB
    frame; so do a one-channel (H, W, 1) frame, which PIL cannot read, and
    a gray-alpha (H, W, 2) frame (PIL's ``LA``)."""
    flax_model, params, _ = shared
    jax_model = JaxSSDPredictor(flax_model, {"params": params}, batch_size=1)
    jax_host = JaxSSDPredictor(flax_model, {"params": params}, batch_size=1,
                               resize_on_device=False)
    model = _port_model(params)
    port = SSDPredictor(model, batch_size=1)
    port_host = SSDPredictor(model, batch_size=1, resize_on_device=False)
    rng = np.random.RandomState(8)
    for hw, pair in (((300, 300), (port, jax_model)), ((240, 320), (port_host, jax_host))):
        for name, frame in _gray_and_rgba(rng, hw).items():
            got = pair[0].predict([frame])[0]
            expected = pair[1].predict([frame])[0]
            assert len(expected) > 0
            report = _mismatch_report(got, expected, cut=-1.0)
            assert not report, f"{name} {hw}:\n" + "\n".join(report)
    frames = _gray_and_rgba(rng, (240, 320))
    frames["gray_1ch"] = frames["gray"][..., None]
    frames["gray_alpha"] = np.stack([frames["gray"], frames["rgba"][..., 3]], -1)
    for name, frame in frames.items():
        plane = frame if frame.ndim == 2 else frame[..., 0]
        rgb = frame[..., :3] if name == "rgba" else np.repeat(plane[..., None], 3, -1)
        np.testing.assert_array_equal(port.predict([frame])[0], port.predict([rgb])[0])
