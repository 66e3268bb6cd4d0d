"""The control of a cell's check: the plain reference computed in a lower
precision than the configuration states, put in the program's place, and
judged as a run judges the program. Its readings set the upper end of each
limit (``PERF.md``).

    python -m perfbench.control --workload <cell> --seconds <s> --seeds 1,2,3 \
        [--dtype float8_e4m3fn|bfloat16] [--fault <name>]

prints one JSON line a seed with the numbers the check compares, for the
reference computed in float8 e4m3 (one below the configurations' bf16);
with ``--dtype bfloat16``, in the configurations' own precision (the
witness of what bf16's rounding alone moves); with ``--fault``, for the
float32 reference with that fault planted, in the program's place (a
training cell's faults, ``FAULTS`` of its driver).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from perfbench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--dtype", default="float8_e4m3fn", choices=("float8_e4m3fn", "bfloat16"))
    p.add_argument("--fault", default=None,
                   help="instead of the lower precision, a fault of the driver's FAULTS")
    args = p.parse_args(argv)

    import torch

    cell = harness.load_json("cells", args.workload)
    config = harness.load_json("configs", cell["config"])
    driver = harness.load_module("drivers", cell["driver"])
    for seed in [int(s) for s in args.seeds.split(",")]:
        ns = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0, device="cuda")
        run = harness.Run(ns, args.workload, cell, config, time.perf_counter())
        if args.fault:
            readings = dict(fault=args.fault, **driver.fault(run, args.fault))
        else:
            readings = dict(dtype=args.dtype, **driver.control(run, getattr(torch, args.dtype)))
        print(json.dumps(dict(workload=args.workload, seed=seed, **readings)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
