"""Guards of the PyTorch port: a clean import, the kernel build's flags, no
silent fallback when the kernel or the host C++ cannot be built or
launched, and builders that default to the card and raise without one."""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ssd_keras_torch import (SSDConfig, SSDInputEncoder, graft_entry, native, ssd_7, ssd_300,
                             ssd_512)
from ssd_keras_torch.eval import Evaluator, predict_all_to_json
from ssd_keras_torch.eval import evaluator as evaluator_module
from ssd_keras_torch.kernels import build
from ssd_keras_torch.kernels import nms as nms_kernel
from ssd_keras_torch.models import ssd7 as ssd7_module
from ssd_keras_torch.models import ssd300 as ssd300_module
from ssd_keras_torch.models import ssd512 as ssd512_module

REPO = Path(__file__).resolve().parent.parent


def test_import_needs_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys, ssd_keras_torch\n"
        "for m in pkgutil.walk_packages(ssd_keras_torch.__path__, 'ssd_keras_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert {'ssd_keras_torch.train', 'ssd_keras_torch.data.device_aug',\n"
        "        'ssd_keras_torch.data.streaming', 'ssd_keras_torch.data.prefetch',\n"
        "        'ssd_keras_torch.parallel.sharding', 'ssd_keras_torch.parallel.launch',\n"
        "        'ssd_keras_torch.parallel.dryrun', 'ssd_keras_torch.models.ssd512',\n"
        "        'ssd_keras_torch.optimize', 'ssd_keras_torch.native',\n"
        "        'ssd_keras_torch.eval.evaluator', 'ssd_keras_torch.eval.coco',\n"
        "        'ssd_keras_torch.eval.cocoeval', 'ssd_keras_torch.data.datasets',\n"
        "        'ssd_keras_torch.data.geometric', 'ssd_keras_torch.data.patch_sampling',\n"
        "        'ssd_keras_torch.data.validation', 'ssd_keras_torch.data.misc',\n"
        "        'ssd_keras_torch.data.photometric', 'ssd_keras_torch.data.chains',\n"
        "        'ssd_keras_torch.utils.visualization', 'ssd_keras_torch.models.layers',\n"
        "        'ssd_keras_torch.predictor', 'ssd_keras_torch.utils.profiling',\n"
        "        'ssd_keras_torch.examples', 'ssd_keras_torch.examples.common',\n"
        "        'ssd_keras_torch.examples.ssd300_inference',\n"
        "        'ssd_keras_torch.examples.ssd512_inference',\n"
        "        'ssd_keras_torch.examples.ssd300_evaluation',\n"
        "        'ssd_keras_torch.examples.ssd300_evaluation_coco',\n"
        "        'ssd_keras_torch.examples.ssd7_training',\n"
        "        'ssd_keras_torch.examples.ssd300_training',\n"
        "        'ssd_keras_torch.examples.export_h5',\n"
        "        'ssd_keras_torch.examples.weight_sampling',\n"
        "        'ssd_keras_torch.examples.synthetic_smoke_ssd300',\n"
        "        'ssd_keras_torch.examples.synthvoc_benchmark',\n"
        "        'ssd_keras_torch.examples.run_workflows_synthvoc',\n"
        "        'ssd_keras_torch.examples.aug_chain_ab',\n"
        "        'ssd_keras_torch.examples.bf16_vs_f32_ssd300',\n"
        "        'ssd_keras_torch.examples.evaluator_decode_agreement',\n"
        "        'ssd_keras_torch.examples.coco_decode_bench',\n"
        "        'ssd_keras_torch.examples.profile_breakdown',\n"
        "        'ssd_keras_torch.examples.serving_trunk_bench',\n"
        "        'ssd_keras_torch.examples.streaming_bench',\n"
        "        'ssd_keras_torch.native.jpeg', 'ssd_keras_torch.kernels.jpeg_color',\n"
        "        'ssd_keras_torch.ops.jpeg_color', 'ssd_keras_torch.bench',\n"
        "        'ssd_keras_torch.bench_all', 'ssd_keras_torch.graft_entry'} <= set(sys.modules)\n"
        "bad = {'jax', 'flax', 'optax', 'orbax', 'ssd_keras_tpu', 'h5py', 'PIL', 'triton',\n"
        "       'cv2', 'bs4', 'lxml'}\n"
        "bad &= set(sys.modules)\n"
        "from ssd_keras_torch import native\n"
        "assert native.load_library.cache_info().currsize == 0  # nothing built at import\n"
        "from ssd_keras_torch.kernels import build\n"
        "assert build.load_nvjpeg_library.cache_info().currsize == 0\n"
        "assert native.jpeg._libjpeg.cache_info().currsize == 0\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_host_chains_run_with_opencv_pil_and_jax_absent():
    """With ``cv2``, ``PIL``, ``jax`` and ``ssd_keras_tpu`` made unimportable,
    every module of the port imports, the four chains run on a SynthVOC
    image (every resize mode and warp included), and the predictor's host
    resize and RGB conversion run."""
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in {'cv2', 'PIL', 'jax', 'flax', 'ssd_keras_tpu'}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib, pkgutil, random, numpy as np, ssd_keras_torch\n"
        "for m in pkgutil.walk_packages(ssd_keras_torch.__path__, 'ssd_keras_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert {'ssd_keras_torch.bench', 'ssd_keras_torch.bench_all'} <= set(sys.modules)\n"
        "from ssd_keras_torch.data import SynthVOC, chains, geometric\n"
        "from ssd_keras_torch.predictor import resize_bilinear_pil, to_rgb\n"
        "img, lab = SynthVOC(1, image_size=96).render(0)\n"
        "for make in (lambda: chains.SSDDataAugmentation(96, 96),\n"
        "             chains.DataAugmentationConstantInputSize,\n"
        "             lambda: chains.DataAugmentationVariableInputSize(64, 64),\n"
        "             lambda: chains.DataAugmentationSatellite(64, 64)):\n"
        "    for seed in range(4):\n"
        "        np.random.seed(seed); random.seed(seed)\n"
        "        out, boxes = make()(img.copy(), lab.astype(float))\n"
        "        assert out.dtype == np.uint8 and out.ndim == 3\n"
        "for mode in range(5):\n"
        "    assert geometric.resize_image(img, 50, 70, mode).shape == (50, 70, 3)\n"
        "assert geometric.Rotate(90)(img).shape == (96, 96, 3)\n"
        "assert resize_bilinear_pil(to_rgb(img[..., 0]), 40, 30).shape == (40, 30, 3)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def _build_dir_listing():
    build_dir = REPO / "ssd_keras_torch" / "_build"
    if not build_dir.is_dir():
        return None
    return sorted((p.name, p.stat().st_mtime_ns) for p in build_dir.iterdir())


def test_package_reexports_import_without_jax_and_build_nothing():
    """The five packages that re-export the JAX package's names (``data``,
    ``parallel``, ``utils``, ``kernels``, ``ops``) and the two benchmarks
    (``bench``, ``bench_all``) import in a fresh interpreter with ``jax``
    and the JAX package blocked, load no library and leave ``_build/`` as it
    was."""
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in {'jax', 'jaxlib', 'flax', 'ssd_keras_tpu'}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from ssd_keras_torch.data import prefetch, DeviceSSDAugmentation, device_aug\n"
        "from ssd_keras_torch.data import StreamingDeviceInput, host_decode_batches\n"
        "from ssd_keras_torch.parallel import make_mesh, shard_batch, replicate\n"
        "from ssd_keras_torch.parallel import initialize_distributed, global_batch_from_local\n"
        "from ssd_keras_torch.utils import benchmark_fps, device_sync, trace\n"
        "from ssd_keras_torch.kernels import greedy_nms_mask_batched, build, nms, jpeg_color\n"
        "from ssd_keras_torch.ops import anchors, boxes, matching\n"
        "from ssd_keras_torch import native, bench, bench_all\n"
        "from ssd_keras_torch.utils.profiling import counters\n"
        "assert callable(prefetch) and not counters()\n"
        "assert len(bench_all.row_names()) == 27 and bench.BASELINE_FPS[8] == 49.0\n"
        "assert build.load_library.cache_info().currsize == 0\n"
        "assert build.load_nvjpeg_library.cache_info().currsize == 0\n"
        "assert native.load_library.cache_info().currsize == 0\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in {'jax', 'ssd_keras_tpu'}]\n"
    )
    before = _build_dir_listing()
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    assert _build_dir_listing() == before


def test_nvcc_command_targets_hopper_with_exact_float_math(tmp_path):
    cmd = build.nvcc_command("nvcc", [tmp_path / "a.cu", tmp_path / "b.cu"], tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--fmad=false" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert cmd[-2:] == [str(tmp_path / "a.cu"), str(tmp_path / "b.cu")]
    assert cmd[cmd.index("-o") + 1] == str(tmp_path / "lib.so")


def test_library_name_follows_the_sources(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build._library_path([src])
    src.write_text("// two\n")
    assert build._library_path([src]) != first


@pytest.fixture()
def no_build_dir(tmp_path, monkeypatch):
    """An empty build directory, so nothing is loaded from an earlier build."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path / "_build"


def test_missing_nvcc_raises(no_build_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library.__wrapped__()
    assert not list(no_build_dir.glob("*.so"))


def _fake_nvcc(tmp_path, script):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + script)
    nvcc.chmod(0o755)
    return bindir


def test_failed_build_raises(no_build_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(_fake_nvcc(tmp_path, "echo 'error: bad' >&2\nexit 1\n")))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.load_library.__wrapped__()
    assert not list(no_build_dir.iterdir())  # the half-built file is removed


def test_unloadable_library_raises(no_build_dir, tmp_path, monkeypatch):
    # An "nvcc" that writes a file that is not a shared library to its -o.
    script = 'while [ "$1" != "-o" ]; do shift; done\necho junk > "$2"\n'
    monkeypatch.setenv("PATH", str(_fake_nvcc(tmp_path, script)))
    with pytest.raises(RuntimeError, match="cannot load"):
        build.load_library.__wrapped__()


def test_wrapper_has_no_fallback_for_other_devices():
    boxes = torch.empty(2, 5, 4, device="meta")
    valid = torch.empty(2, 5, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="device"):
        nms_kernel.greedy_nms_mask_batched(boxes, valid)


def test_kernel_source_is_where_the_build_looks():
    assert (build.CSRC_DIR / "nms.cu").is_file()
    assert [p.name for p in build._sources()] == ["conv_epilogue.cu", "jpeg_color.cu", "nms.cu",
                                                  "resize_linear.cu"]
    assert os.path.basename(build.BUILD_DIR) == "_build"
    # The nvJPEG decoder is a library of its own, outside the kernels' glob.
    assert build.NVJPEG_SOURCE.is_file() and build.NVJPEG_SOURCE.parent.name == "native"


_BUILDERS = {
    "ssd_300": lambda: ssd_300(SSDConfig.ssd300()),
    "ssd_7": lambda: ssd_7(SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64)),
    "SSDInputEncoder": lambda: SSDInputEncoder(
        SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64), [(8, 8)]),
    "graft_entry": lambda: graft_entry.entry(),
}


@pytest.mark.parametrize("builder", [ssd_300, ssd_7, SSDInputEncoder.__init__, graft_entry.entry],
                         ids=["ssd_300", "ssd_7", "SSDInputEncoder", "graft_entry"])
def test_builders_default_to_the_card(builder):
    assert inspect.signature(builder).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(_BUILDERS))
def test_builder_without_a_card_raises_and_builds_nothing(name, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    built = []
    monkeypatch.setattr(ssd300_module, "SSD300", lambda *a, **k: built.append("SSD300"))
    monkeypatch.setattr(ssd7_module, "SSD7", lambda *a, **k: built.append("SSD7"))
    monkeypatch.setattr(SSDConfig, "anchor_tensor", lambda *a, **k: built.append("anchors"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _BUILDERS[name]()
    assert built == []


def test_gxx_command_builds_a_shared_library(tmp_path):
    cmd = native.gxx_command("g++", tmp_path / "a.cpp", tmp_path / "lib.so")
    assert cmd[:4] == ["g++", "-O3", "-shared", "-fPIC"]
    assert cmd[cmd.index("-o") + 1] == str(tmp_path / "lib.so")
    assert cmd[-1] == str(tmp_path / "a.cpp")
    assert native.SOURCE.is_file() and native.BUILD_DIR == build.BUILD_DIR
    assert native._library_path().parent == native.BUILD_DIR


@pytest.fixture()
def empty_native_build(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    return tmp_path / "_build"


def test_missing_gxx_raises(empty_native_build, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load_library.__wrapped__()
    assert not empty_native_build.exists() or not list(empty_native_build.iterdir())


def test_failed_native_build_raises_with_the_compilers_message(empty_native_build, tmp_path,
                                                               monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    gxx = bindir / "g++"
    gxx.write_text("#!/bin/sh\necho 'error: bad host op' >&2\nexit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*bad host op"):
        native.load_library.__wrapped__()
    assert not list(empty_native_build.iterdir())  # the half-built file is removed


_EVAL_BUILDERS = {
    "ssd_512": lambda: ssd_512(SSDConfig.ssd512()),
    "Evaluator": lambda: Evaluator(model=lambda x: x, n_classes=20, data_generator=None),
    "predict_all_to_json": lambda: predict_all_to_json(
        "unused.json", lambda x: x, 300, 300, {}, None, batch_size=8),
}


@pytest.mark.parametrize("builder", [ssd_512, Evaluator.__init__, predict_all_to_json],
                         ids=["ssd_512", "Evaluator", "predict_all_to_json"])
def test_evaluation_entry_points_default_to_the_card(builder):
    assert inspect.signature(builder).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(_EVAL_BUILDERS))
def test_evaluation_entry_point_without_a_card_raises_and_builds_nothing(name, monkeypatch,
                                                                         tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    monkeypatch.chdir(tmp_path)
    built = []
    monkeypatch.setattr(ssd512_module, "SSD512", lambda *a, **k: built.append("SSD512"))
    monkeypatch.setattr(SSDConfig, "anchor_tensor", lambda *a, **k: built.append("anchors"))
    monkeypatch.setattr(evaluator_module, "upload_batch", lambda *a: built.append("upload"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _EVAL_BUILDERS[name]()
    assert built == [] and not list(tmp_path.iterdir())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
@pytest.mark.parametrize("example, argv", [
    ("ssd300_inference", ["missing.jpg"]),
    ("ssd512_inference", ["missing.jpg"]),
    ("ssd300_evaluation", ["--voc_root", "missing"]),
    ("ssd300_evaluation_coco", ["--images_dir", "missing", "--annotations", "missing.json"]),
    ("ssd7_training", ["--images_dir", "missing", "--train_labels", "missing.csv"]),
    ("ssd300_training", ["--voc_root", "missing"]),
    ("synthetic_smoke_ssd300", []),
    ("synthvoc_benchmark", ["--out", "missing_out"]),
    ("run_workflows_synthvoc", ["--root", "missing_root"]),
    ("aug_chain_ab", ["--out", "missing_out"]),
    ("bf16_vs_f32_ssd300", ["--out", "missing.md"]),
    ("evaluator_decode_agreement", ["--ckpt", "missing", "--out", "missing.md"]),
    ("coco_decode_bench", ["--out", "missing.md"]),
    ("profile_breakdown", ["--out", "missing.md"]),
    ("serving_trunk_bench", ["--flags", "--out", "missing.md"]),
    ("streaming_bench", ["--out", "missing.md"]),
])
def test_examples_default_to_the_card_and_raise_without_one(example, argv, tmp_path,
                                                           monkeypatch):
    """Every example runs on ``cuda`` unless given ``--device cpu``, and
    without a card it raises before it reads or writes anything."""
    import importlib

    monkeypatch.chdir(tmp_path)
    module = importlib.import_module(f"ssd_keras_torch.examples.{example}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("module", ["native/jpeg.py", "native/__init__.py",
                                    "kernels/jpeg_color.py", "ops/jpeg_color.py",
                                    "kernels/resize.py", "ops/resize.py",
                                    "kernels/build.py", "data/datasets.py"])
def test_jpeg_modules_import_neither_jax_nor_the_jax_package(module):
    """The JPEG decoder's modules name no import of ``jax``, ``flax`` or
    ``ssd_keras_tpu``, at the top or inside a function."""
    import ast

    tree = ast.parse((REPO / "ssd_keras_torch" / module).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "flax", "ssd_keras_tpu"}, names
