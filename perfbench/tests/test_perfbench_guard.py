"""What a run may load and where it may run: no JAX, flax or
``ssd_keras_tpu`` by top-level name, no ``ssd_keras_torch`` in the
reference, and no result without a card."""

import json
import os
import shutil
import subprocess
import sys

from perfbench import harness

CHECKOUT = str(harness.CHECKOUT)


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=CHECKOUT, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_drivers_and_readers_load_no_forbidden_module():
    code = ("from perfbench import harness, run, control, sweep\n"
            "man = harness.manifest()\n"
            "[harness.load_module('drivers', harness.load_json('cells', w['name'])['driver'])"
            " for w in man['workloads']]\n"
            "[harness.load_module('metrics', m['name']) for m in man['per_layer']]\n")
    loaded = _loaded(code)
    assert "ssd_keras_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    # Every architecture file, and what each configuration asks of its own.
    code = ("import perfbench.reference.ssd, perfbench.reference.decode, "
            "perfbench.reference.compare, perfbench.reference.voc, "
            "perfbench.counts.flops, perfbench.counts.roofline, perfbench.weights\n"
            "from perfbench import harness\n"
            "from perfbench.counts import flops\n"
            "from perfbench.reference import ssd\n"
            "[harness.load_module('architectures', p.stem)"
            " for p in sorted((harness.ROOT / 'architectures').glob('*.py'))"
            " if p.stem != '__init__']\n"
            "for c in harness.manifest()['configs']:\n"
            "    config = harness.load_json('configs', c['name'])\n"
            "    ssd.anchors(config), flops.train_flops(config), ssd.parameter_shapes(config)\n"
            "    ssd.architecture(config).PORT_BUILDER\n")
    loaded = _loaded(code)
    assert not loaded & {"ssd_keras_torch", *harness.FORBIDDEN}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "ssd_keras_tpu_extra.mod", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_without_a_card_the_command_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "ssd300_voc.serve_overload", "--seed", "3000000000", "--seconds", "1",
                          "--trace", "0"], cwd=CHECKOUT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_in_a_tree_with_only_the_benchmark_the_command_fails(tmp_path):
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "ssd300_voc.serve_overload", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
