"""Each architecture's tables, reference forward, weights, FLOP count and
port builder come from one file, ``architectures/<architecture>.py``, found
by the configuration's ``architecture``.

The numbers of the benchmark's configurations are pinned to what the
harness gave before the architectures moved into their files (sha256 at
seed 5; FLOPs an image). A new architecture joins with new files only: a
copy of SSD300's file under another name, and one that declares a
BatchNorm, reach the weights, the anchors, the reference, both FLOP counts,
the port and a driver."""

import hashlib
import json
import shutil

import numpy as np
import pytest
import torch

from perfbench import harness, port, weights
from perfbench.counts import flops
from perfbench.reference import ssd
from perfbench.reference import train as ref_train

PINNED = {
    "ssd300_voc": dict(
        params="6dd5a9c997ea838cca5fce7e190fd88da496bfb7e7a19de25bf02f82a91d06ce",
        anchors="ef236a4de33b62e3b8fd26c648fc84d41af9c89ac43c3aa42f05f2a3e09ffd6c",
        forward="4d53697c988b8c6004159222734fa6f86cb404313db456a54d8a87a08fe9c5c3",
        forward_flops=62747075584, train_flops=187930186752),
    "ssd512_voc": dict(
        params="09a8d93d7f0b01cf3d753bb2c19ecc7f90458f10fa3691c3d534eef4ded4f4f7",
        anchors="952199837f96f05f26f50091f8321c0e967c4e7dcfe767ab2450ee9e05afb566",
        forward="8e1656f0f344f787b6c814f9200a16574b6a4af6e9d956a4a5049fa637eb0c26",
        forward_flops=180415817728, train_flops=540341483520),
}
# A BatchNorm after conv1_1, declared by an architecture file of its own.
BN = {"conv1_1_bn.weight": 1.0, "conv1_1_bn.bias": 0.0, "conv1_1_bn.running_mean": 0.0,
      "conv1_1_bn.running_var": 1.0}
PROBE_BN = f'''
from perfbench import harness

_base = harness.load_module("architectures", "ssd300")
PORT_BUILDER = _base.PORT_BUILDER
conv_table, feature_sizes, sources, forward = (
    _base.conv_table, _base.feature_sizes, _base.sources, _base.forward)


def parameters(config):
    out = {{}}
    for name, entry in _base.parameters(config).items():
        out[name] = entry
        if name == "conv1_1.bias":
            out.update({{k: ((64,), ("constant", v)) for k, v in {BN!r}.items()}})
    return out
'''
# Appended to a copy of ssd300.py: each function records its calls.
SPY = '''

SEEN = []


def _spied(f):
    def g(*args, **kwargs):
        SEEN.append(f.__name__)
        return f(*args, **kwargs)
    return g


conv_table, feature_sizes, sources, parameters, forward = map(
    _spied, (conv_table, feature_sizes, sources, parameters, forward))
'''


def _sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.contiguous().numpy().tobytes() if isinstance(a, torch.Tensor) else a.tobytes())
    return h.hexdigest()


def _params_sha(params) -> str:
    h = hashlib.sha256()
    for name, value in params.items():
        h.update(name.encode())
        h.update(repr(tuple(value.shape)).encode())
        h.update(value.numpy().tobytes())
    return h.hexdigest()


def _images(config, n=2):
    return torch.rand((n, config["img_height"], config["img_width"], 3),
                      generator=torch.Generator().manual_seed(1)) * 255


@pytest.mark.parametrize("name", sorted(PINNED))
def test_weights_anchors_and_flops_are_the_pinned_ones(name):
    config = harness.load_json("configs", name)
    want = PINNED[name]
    assert _params_sha(weights.seeded(config, 5, torch.device("cpu"))) == want["params"]
    assert _sha(ssd.anchors(config)) == want["anchors"]
    assert flops.forward_flops(config) == want["forward_flops"]
    assert flops.train_flops(config) == want["train_flops"]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_reference_forward_is_the_pinned_one(name):
    # One thread: the CPU's float32 convolutions sum in an order that
    # depends on the thread count (and the instruction set: the digests are
    # of an x86-64 CPU with AVX-512).
    config = harness.load_json("configs", name)
    params = weights.seeded(config, 5, torch.device("cpu"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            scores, offsets = ssd.forward(config, params, _images(config))
    finally:
        torch.set_num_threads(threads)
    assert _sha(scores, offsets) == PINNED[name]["forward"]


def test_the_generic_modules_name_no_architecture():
    for path in ("port.py", "weights.py", "counts/flops.py", "reference/ssd.py"):
        text = (harness.ROOT / path).read_text().lower()
        for word in ("ssd300", "ssd512", "_vgg", "conv1_1", "conv4_3", "_mbox_loc"):
            assert word not in text, (path, word)


@pytest.fixture
def copy(tmp_path, monkeypatch):
    """A copy of ``perfbench/`` that the harness finds in its place, and a
    check that a test added files to it and edited none."""
    root = tmp_path / "perfbench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    monkeypatch.setattr(harness, "ROOT", root)
    yield root
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel


def _add_architecture(root, name: str, text: str) -> dict:
    """``architectures/<name>.py`` and, with SSD300 VOC's sizes, its
    configuration, a serving cell and the cell's tiny sizes: new files."""
    base = "ssd300_voc.serve_overload"
    files = {
        f"architectures/{name}.py": text,
        f"configs/{name}.json": json.dumps(dict(harness.load_json("configs", "ssd300_voc"),
                                                name=name, architecture=name)),
        f"cells/{name}.serve_overload.json": json.dumps(dict(harness.load_json("cells", base),
                                                             config=name)),
        f"tests/tiny/{name}.serve_overload.json": (root / "tests" / "tiny" /
                                                    f"{base}.json").read_text(),
    }
    for rel, content in files.items():
        assert not (root / rel).exists()
        (root / rel).write_text(content)
    return harness.load_json("configs", name)


def test_a_new_architecture_joins_with_new_files_only(copy, tiny_run):
    vgg = harness.load_json("configs", "ssd300_voc")
    probe = _add_architecture(copy, "probe",
                              (copy / "architectures" / "ssd300.py").read_text() + SPY)
    seen = ssd.architecture(probe).SEEN
    cpu = torch.device("cpu")
    params = weights.seeded(probe, 5, cpu)
    want = weights.seeded(vgg, 5, cpu)
    assert list(params) == list(want) and all(torch.equal(params[k], want[k]) for k in want)
    assert np.array_equal(ssd.anchors(probe), ssd.anchors(vgg))
    assert flops.forward_flops(probe) == flops.forward_flops(vgg)
    assert flops.train_flops(probe) == flops.train_flops(vgg)
    x = _images(probe, 1)
    model = port.model(dict(probe, compute_dtype="float32"), "training", params, cpu)
    with torch.no_grad():
        got = ssd.forward(probe, params, x)
        ref = ssd.forward(vgg, want, x)
        y = model(x)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    c = probe["n_classes"] + 1
    assert torch.allclose(y[..., :c], got[0], atol=1e-5)
    assert {"conv_table", "feature_sizes", "sources", "parameters", "forward"} <= set(seen)
    del seen[:]
    run = tiny_run("probe.serve_overload", 3000000017)
    assert run.correct and run.attempted > 0, run.checks
    assert {"parameters", "forward", "sources"} <= set(seen)


def test_a_batchnorm_gets_its_constants_and_no_flops(copy):
    vgg = harness.load_json("configs", "ssd300_voc")
    probe = _add_architecture(copy, "probe_bn", PROBE_BN)
    params = weights.seeded(probe, 5, torch.device("cpu"))
    want = weights.seeded(vgg, 5, torch.device("cpu"))
    for name, value in BN.items():
        assert params[name].dtype == torch.float32
        assert torch.equal(params[name], torch.full((64,), value))
    # The BatchNorm draws nothing: every other parameter is SSD300's.
    assert set(params) - set(BN) == set(want)
    assert all(torch.equal(params[k], want[k]) for k in want)
    assert ssd.parameter_shapes(probe)["conv1_1_bn.running_var"] == (64,)
    # The reference's L2 penalty covers the kernels alone, as the port's does.
    assert ref_train.l2_kernels(probe) == ref_train.l2_kernels(vgg)
    assert ref_train.l2_kernels(vgg) == [k for k in want if k.endswith(".weight")]
    assert flops.forward_flops(probe) == flops.forward_flops(vgg)
    assert flops.train_flops(probe) == flops.train_flops(vgg)
