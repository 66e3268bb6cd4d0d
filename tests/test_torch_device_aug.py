"""The port's on-device augmentation against the JAX package's.

Philox and Threefry draw different numbers, so the two are held together
in two ways:

* given the JAX package's own draws (made here from its keys the way
  ``ssd_keras_tpu/data/device_aug.py`` splits them), the port's apply
  functions compute its results: HSV, ``photometric_distortions``, the view
  rectangle of ``sample_geometry``, ``apply_geometry`` and the whole
  ``DeviceSSDAugmentation``;
* the port's own sampler by distribution over 4096 draws against the JAX
  sampler's: expand, crop, flip and photometric gate shares within
  ``SHARE_TOL`` = 0.03, and the mean view scale within 5%.

Tolerances, given the same draws: both sides run the same f32 operations
in the same order, except that XLA may fuse a multiply-add and contracts
the resample's two axes in its own order. A fused multiply-add moves a
sample position (up to ~200 px in an expanded view) by an ulp, ~1.5e-5 px,
and an output pixel by that times the step between two neighbouring input
pixels (at most 255): so pixels (0-255) agree within ``PIXEL_TOL`` = 1e-2
(2.8e-3 seen), HSV within ``HSV_TOL`` = 1e-3, and rectangles and boxes
(pixels) within ``COORD_TOL`` = 1e-3. The fixtures jitter box coordinates so that no centre
sits on the validity boundary and no candidate's IoU on its bound, where
one rounding step would flip a decision. Keep flags, counts and flips are
compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_keras_tpu.data import device_aug as JDA
from ssd_keras_torch.data import device_aug as DA

torch.set_num_threads(2)

PIXEL_TOL = 1e-2
HSV_TOL = 1e-3
COORD_TOL = 1e-3
SHARE_TOL = 0.03
SCALE_RTOL = 0.05
N_DIST = 4096
BG = (123.0, 117.0, 104.0)


def _jax_draws(key, batch, n_candidates=32):
    """The JAX package's per-sample draws for ``DeviceSSDAugmentation(key)``
    over ``batch`` samples, as the port's draw tuples."""

    def one(k):
        k_photo, k_geom = jax.random.split(k)
        pk = jax.random.split(k_photo, 9)

        def u(kk, lo=0.0, hi=1.0):
            return jax.random.uniform(kk, minval=lo, maxval=hi)

        photo = (u(pk[0]) >= 0.5, u(pk[1], -32.0, 32.0), u(pk[3]) >= 0.5, u(pk[4]) >= 0.5,
                 u(pk[2], 0.5, 1.5), u(pk[5]) >= 0.5, u(pk[6], 0.5, 1.5), u(pk[7]) >= 0.5,
                 u(pk[8], -18.0, 18.0))
        k_exp, k_exp_s, k_exp_pos, k_crop = jax.random.split(k_geom, 4)
        ck = jax.random.split(k_crop, n_candidates + 1)

        def cand(kc):
            ks = jax.random.split(kc, 4)
            return (jax.random.randint(ks[0], (), 0, 6),
                    jax.random.uniform(ks[1], (2,), minval=0.3, maxval=1.0),
                    jax.random.uniform(ks[2], (2,)))

        bound, scale, pos = jax.vmap(cand)(ck[1:])
        geom = (u(k_exp) >= 0.5, u(k_exp_s, 1.0, 4.0), jax.random.uniform(k_exp_pos, (2,)),
                u(ck[0]) >= 1.0 - 0.857, bound, scale, pos,
                u(jax.random.fold_in(k_geom, 7)) >= 0.5)
        return photo, geom

    photo, geom = jax.jit(jax.vmap(one))(jax.random.split(key, batch))
    t = [torch.from_numpy(np.array(a)) for a in geom]
    t[4] = t[4].to(torch.int64)
    return DA.AugDraws(DA.PhotometricDraws(*(torch.from_numpy(np.array(a)) for a in photo)),
                       DA.GeometryDraws(*t))


def _photo_keys(key, batch):
    return jax.vmap(lambda k: jax.random.split(k)[0])(jax.random.split(key, batch))


def _geom_keys(key, batch):
    return jax.vmap(lambda k: jax.random.split(k)[1])(jax.random.split(key, batch))


def _labels(rng, batch, max_gt, height, width):
    """Padded (B, M, 5) labels with jittered, non-integer corners and
    1..max_gt live rows per image, and the counts."""
    n_valid = rng.randint(1, max_gt + 1, batch).astype(np.int32)
    labels = np.zeros((batch, max_gt, 5), np.float32)
    for b in range(batch):
        for m in range(n_valid[b]):
            w, h = rng.uniform(0.1, 0.6) * width, rng.uniform(0.1, 0.6) * height
            x0, y0 = rng.uniform(0, width - w), rng.uniform(0, height - h)
            labels[b, m] = (rng.randint(1, 4), x0 + 0.013, y0 + 0.029, x0 + w + 0.007,
                            y0 + h + 0.011)
    return labels, n_valid


@pytest.fixture(scope="module")
def batch():
    """16 images of 48x64 (uint8 values as f32), labels, and JAX's draws."""
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (16, 48, 64, 3)).astype(np.float32)
    labels, n_valid = _labels(rng, 16, 6, 48, 64)
    key = jax.random.PRNGKey(11)
    draws = _jax_draws(key, 16)
    # Force a spread of cases: expand on the first half, flip on every other.
    geom = draws.geometry._replace(expand=torch.arange(16) < 8,
                                   flip=torch.arange(16) % 2 == 0)
    return images, labels, n_valid, key, draws._replace(geometry=geom)


# --------------------------------------------------------------------------- #
# Colour space
# --------------------------------------------------------------------------- #


def test_rgb_to_hsv_equals_jax():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (32, 32, 3)).astype(np.float32)
    img[0, :8] = [[v, v, v] for v in range(0, 256, 32)]  # greys: S = 0, H = 0
    img[1, :6] = [[255, 0, 0], [255, 255, 0], [0, 255, 0], [0, 255, 255], [0, 0, 255],
                  [255, 0, 1]]  # sextant edges; the last wraps below 0
    got = DA.rgb_to_hsv(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, np.asarray(JDA.rgb_to_hsv(jnp.asarray(img))), rtol=0,
                               atol=HSV_TOL)


def test_hsv_to_rgb_equals_jax_and_wraps_at_180():
    rng = np.random.RandomState(2)
    hsv = np.stack([rng.uniform(0, 180, (32, 32)), rng.uniform(0, 255, (32, 32)),
                    rng.uniform(0, 255, (32, 32))], axis=-1).astype(np.float32)
    hsv[0, :4, 0] = [0.0, 30.0, 150.0, 180.0]  # 180 wraps to sextant 0 (floor modulo)
    got = DA.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
    np.testing.assert_allclose(got, np.asarray(JDA.hsv_to_rgb(jnp.asarray(hsv))), rtol=0,
                               atol=HSV_TOL)
    back = DA.hsv_to_rgb(DA.rgb_to_hsv(torch.from_numpy(hsv[..., ::-1].copy())))
    np.testing.assert_allclose(back.numpy(), hsv[..., ::-1], atol=HSV_TOL)


# --------------------------------------------------------------------------- #
# Apply functions given the JAX package's draws
# --------------------------------------------------------------------------- #


def test_photometric_distortions_equal_jax_given_its_draws(batch):
    images, _, _, key, draws = batch
    d = draws.photometric
    for gate in (d.brightness_gate, d.contrast_first, d.contrast_gate, d.saturation_gate,
                 d.hue_gate):
        assert 0 < int(gate.sum()) < 16  # both branches of every choice
    expected = jax.jit(jax.vmap(JDA.photometric_distortions))(
        _photo_keys(key, 16), jnp.asarray(images))
    got = DA.photometric_distortions(torch.from_numpy(images), d)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=PIXEL_TOL)


def test_view_rectangle_equals_jax_sample_geometry_given_its_draws():
    rng = np.random.RandomState(3)
    labels, n_valid = _labels(rng, 256, 6, 300, 300)
    key = jax.random.PRNGKey(4)
    draws = _jax_draws(key, 256).geometry
    rect_j, flip_j = jax.jit(jax.vmap(
        lambda k, b, n: JDA.sample_geometry(k, b, n, 300, 300)))(
        _geom_keys(key, 256), jnp.asarray(labels[..., 1:5]), jnp.asarray(n_valid))
    rect, flip = DA.geometry_from_draws(draws, torch.from_numpy(labels[..., 1:5]),
                                        torch.from_numpy(n_valid).long(), 300, 300)
    np.testing.assert_allclose(rect.numpy(), np.asarray(rect_j), rtol=0, atol=COORD_TOL)
    np.testing.assert_array_equal(flip.numpy(), np.asarray(flip_j))
    rect = rect.numpy()
    off_image = (rect[:, :2] < 0).any(1) | (rect[:, 2:] > 300).any(1)
    cropped = ((rect[:, 2] - rect[:, 0]) < 299) & ~draws.expand.numpy()
    assert off_image.sum() > 20 and cropped.sum() > 20  # expands and crops both seen


def test_apply_geometry_equals_jax_given_the_same_view(batch):
    images, labels, n_valid, key, draws = batch
    boxes, nv = torch.from_numpy(labels[..., 1:5]), torch.from_numpy(n_valid).long()
    rect, flip = DA.geometry_from_draws(draws.geometry, boxes, nv, 48, 64)
    assert bool(flip.any()) and not bool(flip.all())
    assert bool(((rect[:, :2] < 0).any(1) | (rect[:, 2] > 48) | (rect[:, 3] > 64)).any())
    out_j, boxes_j, keep_j = jax.jit(jax.vmap(
        lambda im, b, n, r, f: JDA.apply_geometry(im, b, n, r, f, 40, 56, jnp.asarray(BG))))(
        jnp.asarray(images), jnp.asarray(labels[..., 1:5]), jnp.asarray(n_valid),
        jnp.asarray(rect.numpy()), jnp.asarray(flip.numpy()))
    out, new_boxes, keep = DA.apply_geometry(torch.from_numpy(images), boxes, nv, rect, flip,
                                             40, 56, torch.tensor(BG))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0, atol=PIXEL_TOL)
    np.testing.assert_allclose(new_boxes.numpy(), np.asarray(boxes_j), rtol=0, atol=COORD_TOL)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    assert 0 < int(keep.sum()) < int(nv.sum())  # some boxes dropped, some kept


def test_device_augmentation_equals_jax_given_its_draws():
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (16, 48, 64, 3)).astype(np.uint8)
    labels, n_valid = _labels(rng, 16, 6, 48, 64)
    key = jax.random.PRNGKey(6)
    out_j, labels_j, counts_j = JDA.DeviceSSDAugmentation(40, 56)(key, images, labels, n_valid)
    aug = DA.DeviceSSDAugmentation(40, 56)
    out, new_labels, counts = aug.apply(_jax_draws(key, 16), torch.from_numpy(images),
                                        torch.from_numpy(labels), torch.from_numpy(n_valid))
    assert out.dtype == torch.float32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0, atol=PIXEL_TOL)
    np.testing.assert_allclose(new_labels.numpy(), np.asarray(labels_j), rtol=0, atol=COORD_TOL)
    # Kept rows first, zeros after them.
    for b in range(16):
        assert not new_labels[b, counts[b]:].any()


# --------------------------------------------------------------------------- #
# The port's sampler by distribution
# --------------------------------------------------------------------------- #


def _view_np(expand, ratio, offset, size):
    h = size * ratio
    y0, x0 = -offset[:, 0] * (h - size), -offset[:, 1] * (h - size)
    full = np.array([0.0, 0.0, size, size])
    return np.where(expand[:, None], np.stack([y0, x0, y0 + h, x0 + h], axis=1), full)


def _shares(draws, rect, flip):
    g = draws.geometry
    view = _view_np(g.expand.numpy(), g.expand_ratio.numpy(), g.expand_offset.numpy(), 300)
    rect = np.asarray(rect)
    cropped = np.abs(rect - view).max(axis=1) > COORD_TOL
    p = draws.photometric
    scale = np.sqrt((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])) / 300
    return dict(expand=float(g.expand.float().mean()), crop=float(cropped.mean()),
                flip=float(np.asarray(flip).mean()),
                **{name: float(getattr(p, name).float().mean())
                   for name in ("brightness_gate", "contrast_first", "contrast_gate",
                                "saturation_gate", "hue_gate")}), float(scale.mean())


def test_sampler_distribution_equals_jax():
    boxes = np.array([[[100.3, 100.7, 200.1, 210.9], [30.2, 40.6, 90.4, 140.8]]], np.float32)
    boxes = np.repeat(boxes, N_DIST, axis=0)
    n_valid = np.full(N_DIST, 2)
    key = jax.random.PRNGKey(8)
    jdraws = _jax_draws(key, N_DIST)
    rect_j, flip_j = jax.jit(jax.vmap(
        lambda k, b, n: JDA.sample_geometry(k, b, n, 300, 300)))(
        _geom_keys(key, N_DIST), jnp.asarray(boxes), jnp.asarray(n_valid))
    jax_shares, jax_scale = _shares(jdraws, rect_j, flip_j)

    aug = DA.DeviceSSDAugmentation(300, 300)
    draws = aug.draw(seed=9, batch=N_DIST, device="cpu")
    rect, flip = DA.geometry_from_draws(draws.geometry, torch.from_numpy(boxes),
                                        torch.from_numpy(n_valid), 300, 300)
    shares, scale = _shares(draws, rect.numpy(), flip.numpy())
    for name, value in jax_shares.items():
        assert abs(shares[name] - value) <= SHARE_TOL, (name, shares[name], value)
    assert abs(scale - jax_scale) <= SCALE_RTOL * jax_scale, (scale, jax_scale)
    d = draws.geometry
    assert float(d.expand_ratio.min()) >= 1.0 and float(d.expand_ratio.max()) < 4.0
    assert float(d.crop_scale.min()) >= 0.3 and float(d.crop_scale.max()) < 1.0
    counts = np.bincount(d.bound_index.reshape(-1).numpy(), minlength=6) / d.bound_index.numel()
    np.testing.assert_allclose(counts, 1 / 6, atol=SHARE_TOL)


# --------------------------------------------------------------------------- #
# Draws over the global batch: a rank's rows are the batch's rows
# --------------------------------------------------------------------------- #


class _Mesh:
    """The two methods of a 1-D ``DeviceMesh`` the augmentation reads."""

    def __init__(self, rank, size):
        self.rank, self.n = rank, size

    def get_local_rank(self, dim=None):
        return self.rank

    def size(self):
        return self.n


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_rank_rows_equal_the_global_batch_rows_bit_for_bit(rank):
    rng = np.random.RandomState(10)
    images = torch.from_numpy(rng.randint(0, 256, (8, 48, 64, 3)).astype(np.uint8))
    labels, n_valid = _labels(rng, 8, 6, 48, 64)
    labels, n_valid = torch.from_numpy(labels), torch.from_numpy(n_valid)
    whole = DA.DeviceSSDAugmentation(40, 56)(123, images, labels, n_valid)
    rows = slice(2 * rank, 2 * rank + 2)
    part = DA.DeviceSSDAugmentation(40, 56, mesh=_Mesh(rank, 4))(
        123, images[rows], labels[rows], n_valid[rows])
    for got, expected in zip(part, whole):
        assert torch.equal(got, expected[rows])


def test_batch_seed_is_a_pure_function_of_seed_and_index():
    seeds = [DA.batch_seed(7, i) for i in range(64)]
    assert seeds == [DA.batch_seed(7, i) for i in range(64)]
    assert len(set(seeds)) == 64 and DA.batch_seed(8, 0) != seeds[0]
    assert all(0 <= s < 2 ** 63 for s in seeds)
