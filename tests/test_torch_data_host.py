"""The port's host data modules against the JAX package's, on the same
seeded inputs and the same ``np.random`` state.

* ``data/validation.py``, ``data/misc.py``, ``data/patch_sampling.py``
  (vendored): equal outputs.
* ``data/photometric.py:ConvertTo3Channels`` (vendored): equal.
* ``data/geometric.py:Resize`` (ported without OpenCV): labels and the
  inverter equal; images within 1 level of ``cv2.resize(INTER_LINEAR)`` on
  every pixel and equal on at least 99% of them; the identity at equal size.
* ``data/datasets.py:DataGenerator`` (vendored): the parsers and
  ``generate(...)`` with the evaluator's arguments give the same image ids,
  labels, neutral flags and inverse transforms; images as for ``Resize``.
* ``data/synthvoc.py:as_data_generator``: the same contents.
"""

import json

import cv2
import numpy as np
import pytest
import torch

from ssd_keras_tpu.data import datasets as jax_datasets
from ssd_keras_tpu.data import geometric as jax_geometric
from ssd_keras_tpu.data import misc as jax_misc
from ssd_keras_tpu.data import patch_sampling as jax_patch
from ssd_keras_tpu.data import photometric as jax_photometric
from ssd_keras_tpu.data import synthvoc as jax_synthvoc
from ssd_keras_tpu.data import validation as jax_validation
from ssd_keras_torch.data import datasets, geometric, misc, patch_sampling, photometric
from ssd_keras_torch.data import synthvoc, validation

torch.set_num_threads(2)

RESIZE_SIZES = [((300, 300), (512, 512)), ((480, 640), (300, 300)), ((375, 500), (512, 512)),
                ((37, 53), (300, 300)), ((500, 353), (300, 300))]


def _labels(rng, n=12, frame=100):
    xy = rng.randint(-10, frame, (n, 2))
    wh = rng.randint(-3, 50, (n, 2))
    return np.concatenate([rng.randint(1, 5, (n, 1)), xy, xy + wh], axis=1).astype(np.float64)


def _same_draws(port_fn, jax_fn, seed, calls=5):
    """Both called ``calls`` times from the same np.random state."""
    out = []
    for fn in (port_fn, jax_fn):
        np.random.seed(seed)
        out.append([fn() for _ in range(calls)])
    return out


def _assert_equal_trees(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal_trees(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("criterion", ["center_point", "iou", "area"])
@pytest.mark.parametrize("border_pixels", ["half", "include", "exclude"])
def test_box_filter_and_image_validator_equal_jax(criterion, border_pixels):
    rng = np.random.RandomState(0)
    labels = _labels(rng)
    kw = dict(overlap_criterion=criterion, border_pixels=border_pixels)
    for bounds in [(0.3, 1.0), (0.0, 0.5)]:
        port = validation.BoxFilter(overlap_bounds=bounds, **kw)(labels, 80, 90)
        jax = jax_validation.BoxFilter(overlap_bounds=bounds, **kw)(labels, 80, 90)
        np.testing.assert_array_equal(port, jax)
        for n_min in (1, 3, "all"):
            port = validation.ImageValidator(bounds=bounds, n_boxes_min=n_min, **kw)
            jax = jax_validation.ImageValidator(bounds=bounds, n_boxes_min=n_min, **kw)
            assert port(labels, 80, 90) == jax(labels, 80, 90)
    port, jax = _same_draws(
        lambda: validation.BoxFilter(overlap_bounds=validation.BoundGenerator(), **kw)(
            labels, 80, 90),
        lambda: jax_validation.BoxFilter(overlap_bounds=jax_validation.BoundGenerator(), **kw)(
            labels, 80, 90), seed=1)
    _assert_equal_trees(port, jax)


def test_bound_generator_equals_jax():
    space = ((0.1, None), (None, 0.5), (0.2, 0.8))
    port, jax = _same_draws(validation.BoundGenerator(space, [0.2, 0.3, 0.5]),
                            jax_validation.BoundGenerator(space, [0.2, 0.3, 0.5]), seed=2, calls=20)
    assert port == jax


@pytest.mark.parametrize("must_match", ["h_w", "h_ar", "w_ar"])
@pytest.mark.parametrize("max_scale", [1.0, 1.8])
def test_patch_coordinate_generator_equals_jax(must_match, max_scale):
    kw = dict(img_height=90, img_width=120, must_match=must_match, min_scale=0.3,
              max_scale=max_scale)
    port, jax = _same_draws(patch_sampling.PatchCoordinateGenerator(**kw),
                            jax_patch.PatchCoordinateGenerator(**kw), seed=3, calls=10)
    assert port == jax


@pytest.mark.parametrize("patch", [(10, 20, 50, 60), (-15, -5, 120, 140), (30, -10, 80, 40)])
@pytest.mark.parametrize("clip_boxes", [True, False])
def test_crop_pad_equals_jax(patch, clip_boxes):
    rng = np.random.RandomState(4)
    image = rng.randint(0, 256, (90, 120, 3)).astype(np.uint8)
    labels = _labels(rng)
    labels = labels[(labels[:, 3] > labels[:, 1]) & (labels[:, 4] > labels[:, 2])]
    kw = dict(clip_boxes=clip_boxes, background=(7, 8, 9))
    p_img, p_lab, p_inv = patch_sampling.CropPad(*patch, **kw)(image, labels, return_inverter=True)
    j_img, j_lab, j_inv = jax_patch.CropPad(*patch, **kw)(image, labels, return_inverter=True)
    np.testing.assert_array_equal(p_img, j_img)
    np.testing.assert_array_equal(p_lab, j_lab)
    preds = np.concatenate([np.ones((len(labels), 1)), labels], axis=1)
    np.testing.assert_array_equal(p_inv(preds), j_inv(preds))


@pytest.mark.parametrize("aspect_ratio", [1.0, 300 / 512, 16 / 9])
def test_random_pad_fixed_ar_and_inverse_transforms_equal_jax(aspect_ratio):
    rng = np.random.RandomState(5)
    image = rng.randint(0, 256, (70, 110, 3)).astype(np.uint8)
    labels = _labels(rng, frame=60)
    labels = labels[(labels[:, 3] > labels[:, 1]) & (labels[:, 4] > labels[:, 2])]
    outs = []
    for mod in (patch_sampling, jax_patch):
        np.random.seed(6)
        outs.append(mod.RandomPadFixedAR(aspect_ratio)(image, labels, return_inverter=True))
    (p_img, p_lab, p_inv), (j_img, j_lab, j_inv) = outs
    np.testing.assert_array_equal(p_img, j_img)
    np.testing.assert_array_equal(p_lab, j_lab)
    rows = np.concatenate([np.ones((len(labels), 1)), rng.rand(len(labels), 1), labels], 1)
    preds = [rows[:, :6], np.zeros((0, 6))]
    np.testing.assert_array_equal(p_inv(preds[0]), j_inv(preds[0]))
    _assert_equal_trees(misc.apply_inverse_transforms(preds, [[p_inv], [p_inv]]),
                        jax_misc.apply_inverse_transforms(preds, [[j_inv], [j_inv]]))


@pytest.mark.parametrize("shape", [(20, 30), (20, 30, 1), (20, 30, 3), (20, 30, 4)])
def test_convert_to_3_channels_equals_jax(shape):
    image = np.random.RandomState(7).randint(0, 256, shape).astype(np.uint8)
    labels = _labels(np.random.RandomState(8))
    p_img, p_lab = photometric.ConvertTo3Channels()(image, labels)
    j_img, j_lab = jax_photometric.ConvertTo3Channels()(image, labels)
    np.testing.assert_array_equal(p_img, j_img)
    np.testing.assert_array_equal(p_lab, j_lab)
    np.testing.assert_array_equal(photometric.ConvertTo3Channels()(image),
                                  jax_photometric.ConvertTo3Channels()(image))


def _smooth_image(rng, h, w):
    """A photo-like image: smooth gradients and blobs plus noise, uint8."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin(6 * xx + c) * np.cos(4 * yy - c) for c in range(3)], -1) * 100 + 128
    return np.clip(base + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("src, dst", RESIZE_SIZES)
def test_resize_within_one_level_of_cv2(src, dst):
    rng = np.random.RandomState(9)
    for image in (rng.randint(0, 256, (*src, 3)).astype(np.uint8), _smooth_image(rng, *src)):
        labels = _labels(rng, frame=min(src))
        kw = dict(labels_format=None)
        p_img, p_lab, p_inv = geometric.Resize(*dst, **kw)(image, labels, return_inverter=True)
        j_img, j_lab, j_inv = jax_geometric.Resize(*dst, **kw)(image, labels, return_inverter=True)
        np.testing.assert_array_equal(p_lab, j_lab)
        preds = np.concatenate([np.ones((len(labels), 1)), rng.rand(len(labels), 1),
                                labels[:, 1:] * 1.37], axis=1)
        np.testing.assert_array_equal(p_inv(preds), j_inv(preds))
        diff = np.abs(p_img.astype(int) - j_img.astype(int))
        assert p_img.shape == j_img.shape and p_img.dtype == np.uint8
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.99


def test_resize_identity_halving_nearest_and_float():
    rng = np.random.RandomState(10)
    image = rng.randint(0, 256, (300, 300, 3)).astype(np.uint8)
    out = geometric.resize_image(image, 300, 300)
    np.testing.assert_array_equal(out, image)
    assert out is not image
    np.testing.assert_array_equal(geometric.resize_image(image, 150, 150),
                                  cv2.resize(image, (150, 150)))
    for src, dst in RESIZE_SIZES:
        image = rng.randint(0, 256, (*src, 3)).astype(np.uint8)
        np.testing.assert_array_equal(
            geometric.resize_image(image, *dst, geometric.INTER_NEAREST),
            cv2.resize(image, dst[::-1], interpolation=cv2.INTER_NEAREST))
        f = image.astype(np.float32)
        np.testing.assert_allclose(geometric.resize_image(f, *dst), cv2.resize(f, dst[::-1]),
                                   rtol=0, atol=1e-2)
    gray = rng.randint(0, 256, (37, 53)).astype(np.uint8)
    for g in (gray, gray[..., None]):
        got = geometric.resize_image(g, 30, 40)
        assert got.shape == cv2.resize(g, (40, 30)).shape == (30, 40)
        assert np.abs(got.astype(int) - cv2.resize(g, (40, 30))).max() <= 1


def test_resize_constants_and_unported_modes():
    for name in ("INTER_NEAREST", "INTER_LINEAR", "INTER_CUBIC", "INTER_AREA", "INTER_LANCZOS4"):
        assert getattr(geometric, name) == getattr(cv2, name)
    for mode in (cv2.INTER_CUBIC, cv2.INTER_AREA, cv2.INTER_LANCZOS4):
        assert geometric.Resize(10, 10, interpolation_mode=mode).interpolation_mode == mode
        assert geometric.resize_image(np.zeros((4, 4, 3), np.uint8), 2, 2, mode).shape == (2, 2, 3)
    for mode in (cv2.INTER_LINEAR_EXACT, 7):  # not modes of the JAX package's Resize
        with pytest.raises(ValueError, match="interpolation mode"):
            geometric.Resize(10, 10, interpolation_mode=mode)
        with pytest.raises(ValueError, match="interpolation mode"):
            geometric.resize_image(np.zeros((4, 4, 3), np.uint8), 2, 2, mode)
    # uint16 is ported; int32 cv2.resize takes in INTER_NEAREST alone.
    assert geometric.resize_image(np.zeros((4, 4, 3), np.uint16), 2, 2).dtype == np.uint16
    with pytest.raises(cv2.error):
        cv2.resize(np.zeros((4, 4, 3), np.int32), (2, 2))
    with pytest.raises(NotImplementedError, match="uint8, uint16, int16 or float"):
        geometric.resize_image(np.zeros((4, 4, 3), np.int32), 2, 2)


def _generators(images, labels, neutral, ids):
    out = []
    for mod in (datasets, jax_datasets):
        gen = mod.DataGenerator(labels=labels, image_ids=ids, eval_neutral=neutral)
        gen.images = images
        gen.dataset_size = len(images)
        gen.dataset_indices = np.arange(len(images), dtype=np.int32)
        out.append(gen)
    return out


def _evaluator_batches(gen, transforms, batch_size, n_batches):
    it = gen.generate(
        batch_size=batch_size, shuffle=False, transformations=transforms, label_encoder=None,
        returns=["processed_images", "image_ids", "evaluation-neutral", "inverse_transforms",
                 "original_labels"],
        keep_images_without_gt=True, degenerate_box_handling="remove")
    return [next(it) for _ in range(n_batches)]


@pytest.mark.parametrize("mode", ["resize", "pad"])
def test_generate_with_the_evaluators_arguments_equals_jax(mode):
    """Images of several sizes, one without boxes, one with a degenerate
    box; batches of 3 over 7 images (a short last batch), then a wrap."""
    rng = np.random.RandomState(11)
    sizes = [(60, 80), (90, 60), (64, 64), (50, 120), (64, 64), (75, 75), (40, 90)]
    images = [_smooth_image(rng, *s) for s in sizes]
    labels = [_labels(rng, n=3, frame=min(s) - 20) for s in sizes]
    labels = [np.abs(lab) for lab in labels]
    labels[2] = np.zeros((0, 5))
    labels[4][0, 3] = labels[4][0, 1]  # degenerate: removed
    neutral = [list(rng.rand(len(lab)) < 0.3) for lab in labels]
    ids = [f"im{i}" for i in range(7)]
    port_gen, jax_gen = _generators(images, labels, neutral, ids)

    def chain(geo, photo, patch):
        out = [photo.ConvertTo3Channels()]
        if mode == "pad":
            out.append(patch.RandomPadFixedAR(patch_aspect_ratio=1.0))
        return out + [geo.Resize(48, 48)]

    np.random.seed(12)
    port = _evaluator_batches(port_gen, chain(geometric, photometric, patch_sampling), 3, 4)
    np.random.seed(12)
    jax = _evaluator_batches(jax_gen, chain(jax_geometric, jax_photometric, jax_patch), 3, 4)
    preds = np.array([[1, 0.5, 3.3, 4.6, 30.2, 40.7], [2, 0.4, 0.0, 1.2, 47.9, 12.5]])
    for (p_x, p_ids, p_neu, p_inv, p_lab), (j_x, j_ids, j_neu, j_inv, j_lab) in zip(port, jax):
        assert p_ids == j_ids and p_neu == j_neu
        _assert_equal_trees(p_lab, j_lab)
        assert p_x.shape == j_x.shape and p_x.dtype == j_x.dtype
        assert np.abs(p_x.astype(int) - j_x.astype(int)).max() <= 1
        for p, j in zip(p_inv, j_inv):
            np.testing.assert_array_equal(misc.apply_inverse_transforms([preds], [p])[0],
                                          jax_misc.apply_inverse_transforms([preds], [j])[0])
    assert [b[1] for b in port] == [ids[0:3], ids[3:6], ids[6:7], ids[0:3]]


def test_as_data_generator_equals_jax():
    port = synthvoc.SynthVOC(6, image_size=64, split="val", seed=3).as_data_generator()
    jax = jax_synthvoc.SynthVOC(6, image_size=64, split="val", seed=3).as_data_generator()
    assert isinstance(port, datasets.DataGenerator)
    assert port.image_ids == jax.image_ids and port.dataset_size == jax.dataset_size == 6
    assert port.eval_neutral is None and jax.eval_neutral is None
    _assert_equal_trees(port.images, jax.images)
    _assert_equal_trees(port.labels, jax.labels)
    np.testing.assert_array_equal(port.dataset_indices, jax.dataset_indices)


def test_parsers_equal_jax(tmp_path):
    """parse_xml over a Pascal-VOC export, parse_json over a COCO export and
    parse_csv over a CSV of the same labels, images read from the files."""
    voc = synthvoc.SynthVOC(4, image_size=64, split="train", seed=1)
    images, labels = voc.materialize()
    voc_images, voc_annotations, voc_set = voc.export_voc(str(tmp_path / "voc"), images, labels)
    img_dir, ann = voc.export_coco(str(tmp_path / "coco"), images, labels)
    csv_path = tmp_path / "labels.csv"
    with open(csv_path, "w") as f:
        f.write("image_name,xmin,xmax,ymin,ymax,class_id\n")
        for i, lab in enumerate(labels):
            for c, x0, y0, x1, y1 in lab:
                f.write(f"im{i}.jpg,{x0},{x1},{y0},{y1},{int(c)}\n")
    results = []
    for mod in (datasets, jax_datasets):
        out = []
        gen = mod.DataGenerator(load_images_into_memory=True)
        out.append(gen.parse_xml([voc_images], [voc_set], [voc_annotations],
                                 classes=["background"] + list(synthvoc.SYNTHVOC_CLASS_NAMES[1:]),
                                 ret=True))
        gen = mod.DataGenerator(load_images_into_memory=True)
        out.append(gen.parse_json([img_dir], [ann], ground_truth_available=True, ret=True))
        out.append((gen.cats_to_classes, gen.classes_to_cats, gen.classes_to_names))
        gen = mod.DataGenerator()
        out.append(gen.parse_csv(str(tmp_path), str(csv_path),
                                 ["image_name", "xmin", "xmax", "ymin", "ymax", "class_id"],
                                 ret=True)[1:])
        results.append(out)
    _assert_equal_trees(json.loads(json.dumps(results[0][2], default=str)),
                        json.loads(json.dumps(results[1][2], default=str)))
    for p, j in zip(results[0][:2] + results[0][3:], results[1][:2] + results[1][3:]):
        _assert_equal_trees(p, j)
    assert len(results[0][0][2]) == 4 and sum(len(lab) for lab in results[0][0][2]) > 0


_VOC_XML = """<annotation>
  <folder>VOC2007</folder>
  <filename>{image_id}.jpg</filename>
  <size><width>500</width><height>375</height><depth>3</depth></size>
  <object>
    <name>person</name>
    <pose>Left</pose>
    <truncated>1</truncated>
    <difficult>0</difficult>
    <bndbox><xmin>10</xmin><ymin>20.7</ymin><xmax>200</xmax><ymax>300</ymax></bndbox>
    <part>
      <name>head</name>
      <bndbox><xmin>50</xmin><ymin>25</ymin><xmax>90</xmax><ymax>70</ymax></bndbox>
    </part>
    <part>
      <name>hand</name>
      <bndbox><xmin>12</xmin><ymin>150</ymin><xmax>30</xmax><ymax>170</ymax></bndbox>
    </part>
  </object>
  <object>
    <name>dog</name>
    <difficult>1</difficult>
    <bndbox><xmin>220</xmin><ymin>200</ymin><xmax>330.5</xmax><ymax>370</ymax></bndbox>
  </object>
  <object>
    <name>unicorn</name>
    <bndbox><xmin>1</xmin><ymin>1</ymin><xmax>5</xmax><ymax>5</ymax></bndbox>
  </object>
  <object>
    <name>car</name>
    <truncated>0</truncated>
    <difficult>1</difficult>
    <bndbox>
      <xmin> 300 </xmin>
      <ymin>40</ymin>
      <xmax>480</xmax>
      <ymax>140</ymax>
    </bndbox>
  </object>
</annotation>
"""


@pytest.mark.parametrize("options", [
    {}, {"exclude_truncated": True}, {"exclude_difficult": True},
    {"include_classes": [7, 15]}])
def test_parse_xml_with_difficult_truncated_and_parts_equals_jax(tmp_path, options):
    """The port reads VOC XML with ElementTree, the JAX package with
    BeautifulSoup: the same filenames, labels, image ids and eval-neutral
    flags, with ``difficult`` and ``truncated`` objects, ``<part>`` sub-boxes
    (never read as objects or boxes), an unknown class, fractional and
    padded coordinates, and an image without objects."""
    ann_dir, set_dir = tmp_path / "Annotations", tmp_path / "ImageSets"
    ann_dir.mkdir()
    set_dir.mkdir()
    ids = ["000005", "000007"]
    (ann_dir / "000005.xml").write_text(_VOC_XML.format(image_id="000005"))
    (ann_dir / "000007.xml").write_text(
        "<annotation><filename>000007.jpg</filename></annotation>\n")
    (set_dir / "test.txt").write_text("\n".join(ids) + "\n")
    results = []
    for mod in (datasets, jax_datasets):
        gen = mod.DataGenerator(load_images_into_memory=False)
        results.append(gen.parse_xml([str(tmp_path / "JPEGImages")], [str(set_dir / "test.txt")],
                                     [str(ann_dir)], ret=True, **options))
    (_, files, labels, image_ids, neutral), (_, j_files, j_labels, j_ids, j_neutral) = results
    assert files == j_files and image_ids == j_ids == ids and neutral == j_neutral
    assert len(labels) == len(j_labels) == 2
    for got, want in zip(labels, j_labels):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if not options:
        np.testing.assert_array_equal(labels[0], [[15, 10, 20, 200, 300], [12, 220, 200, 330, 370],
                                                  [7, 300, 40, 480, 140]])
        assert neutral[0] == [False, True, True] and neutral[1] == []


def test_hdf5_cache_equals_jax(tmp_path):
    voc = synthvoc.SynthVOC(3, image_size=32, split="val", seed=2)
    images, labels = voc.materialize()
    loaded = []
    for name, mod in (("port", datasets), ("jax", jax_datasets)):
        gen = mod.DataGenerator(labels=[np.asarray(lab, np.float64) for lab in labels],
                                image_ids=["a", "b", "c"], eval_neutral=[[False] * len(lab)
                                                                         for lab in labels])
        gen.images, gen.filenames = list(images), ["a.png", "b.png", "c.png"]
        gen.dataset_size = 3
        gen.dataset_indices = np.arange(3, dtype=np.int32)
        gen.create_hdf5_dataset(str(tmp_path / f"{name}.h5"), verbose=False)
        again = mod.DataGenerator(hdf5_dataset_path=str(tmp_path / f"{name}.h5"), verbose=False)
        loaded.append((again.filenames, again.labels, again.image_ids, again.eval_neutral,
                       [again._get_image(i) for i in range(3)]))
        again.hdf5_dataset.close()
        gen.hdf5_dataset.close()
    _assert_equal_trees(loaded[0], loaded[1])
    _assert_equal_trees(loaded[0][4], list(images))
