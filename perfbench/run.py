"""Run one cell of the benchmark and print its result line.

    python -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits non-zero, printing no result, without a
card, with fewer cards than the cell asks for, or when a forbidden module
(JAX, flax, ``ssd_keras_tpu``) was loaded. With ``--trace 0`` the result
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, the card's busy time over the traced window and a breakdown.
The last lines on standard error, and the result's last key, are the
numbers compared with the reference, each beside its limit.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from perfbench import harness  # noqa: E402

# Build and kernel caches at fixed paths inside the checkout: only a
# checkout's first run of a cell builds or compiles.
CACHE = harness.ROOT / ".cache"


def _caches() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
        (CACHE / sub).mkdir(parents=True, exist_ok=True)


def _fail(message: str) -> int:
    print(f"perfbench: {message}", file=sys.stderr, flush=True)
    return 2


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    os.environ["USE_FLAX"] = "0"

    import torch

    man = harness.manifest()
    entry = next((w for w in man["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        return _fail(f"no workload {args.workload!r} in BENCHMARK.json")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < entry["chips"]:
        return _fail(f"{args.workload} needs {entry['chips']} cards, "
                     f"{torch.cuda.device_count()} present")
    cell = harness.load_json("cells", args.workload)
    if cell["config"] != entry["config"]:
        return _fail(f"cells/{args.workload}.json names {cell['config']}, "
                     f"BENCHMARK.json {entry['config']}")
    config = harness.load_json("configs", cell["config"])
    driver = harness.load_module("drivers", cell["driver"])
    run = harness.Run(args, args.workload, cell, config, STARTED)
    driver.run(run)

    e2e, layer = harness.cell_metrics(man, args.workload)
    metrics = {}
    if args.trace:
        for m in layer:
            value = harness.load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    else:
        run.e2e["setup_s"] = run.setup_s
        for m in e2e:
            metrics[m["name"]] = dict(value=float(run.e2e[m["name"]]), unit=m["unit"])
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=entry["chips"],
                  memory_peak_bytes=int(run.memory_peak_bytes))
    result = dict(correct=run.correct, attempted=run.attempted, failed=run.failed,
                  metrics=metrics, device=device)
    if args.trace and run.traced is not None:
        device.update(busy_s=run.traced["busy_s"], window_s=run.traced["window_s"])
        result["breakdown"] = harness.breakdown(run.traced)
    result["checks"] = {c["name"]: dict(value=c["value"], limit=c["limit"]) for c in run.checks}

    found = harness.forbidden_modules()
    if found:
        return _fail(f"forbidden modules loaded: {', '.join(found)}")
    print(f"card: {_card_line()}", file=sys.stderr)
    for c in run.checks:
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
