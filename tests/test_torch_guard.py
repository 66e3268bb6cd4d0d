"""Guards of the PyTorch port: a clean import, the kernel build's flags, no
silent fallback when the kernel cannot be built or launched, and builders
that default to the card and raise without one."""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ssd_keras_torch import SSDConfig, SSDInputEncoder, ssd_7, ssd_300
from ssd_keras_torch.kernels import build
from ssd_keras_torch.kernels import nms as nms_kernel
from ssd_keras_torch.models import ssd7 as ssd7_module
from ssd_keras_torch.models import ssd300 as ssd300_module

REPO = Path(__file__).resolve().parent.parent


def test_import_needs_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys, ssd_keras_torch\n"
        "for m in pkgutil.walk_packages(ssd_keras_torch.__path__, 'ssd_keras_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert {'ssd_keras_torch.train', 'ssd_keras_torch.data.device_aug',\n"
        "        'ssd_keras_torch.data.streaming', 'ssd_keras_torch.data.prefetch',\n"
        "        'ssd_keras_torch.parallel.sharding', 'ssd_keras_torch.parallel.launch',\n"
        "        'ssd_keras_torch.parallel.dryrun'} <= set(sys.modules)\n"
        "bad = {'jax', 'flax', 'ssd_keras_tpu', 'h5py', 'PIL', 'triton'} & set(sys.modules)\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


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
    assert [p.name for p in build._sources()] == ["nms.cu"]
    assert os.path.basename(build.BUILD_DIR) == "_build"


_BUILDERS = {
    "ssd_300": lambda: ssd_300(SSDConfig.ssd300()),
    "ssd_7": lambda: ssd_7(SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64)),
    "SSDInputEncoder": lambda: SSDInputEncoder(
        SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64), [(8, 8)]),
}


@pytest.mark.parametrize("builder", [ssd_300, ssd_7, SSDInputEncoder.__init__],
                         ids=["ssd_300", "ssd_7", "SSDInputEncoder"])
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
