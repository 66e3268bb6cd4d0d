"""Sweep the offered rate of an open-loop serving cell in one process, to
find the knee: the highest rate the program sustains with no growing
backlog. The cell's file then fixes its rate at a share of the knee.

    python -m perfbench.sweep --workload <cell> --seed <n> --seconds <s> --rates 100,150,200

prints one JSON line a rate: latency percentiles over the window, the
median latency of its first and last thirds of requests (a backlog that
grows makes the last third's far longer), and the median service time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from perfbench import harness, port, traffic, weights


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)

    import torch
    from ssd_keras_torch.predictor import SSDPredictor

    cell = harness.load_json("cells", args.workload)
    config = harness.load_json("configs", cell["config"])
    driver = harness.load_module("drivers", cell["driver"])
    ns = argparse.Namespace(seed=args.seed, seconds=args.seconds, trace=0)
    run = harness.Run(ns, args.workload, cell, config, time.perf_counter())
    params = weights.seeded(config, args.seed, run.device)
    predictor = SSDPredictor(port.model(config, "inference", params, run.device),
                             batch_size=cell["batch_size"])
    pools = traffic.image_pool(cell["traffic"], args.seed, run.device)
    for pool in pools:
        predictor.predict(list(pool[: cell["batch_size"]]))
    torch.cuda.synchronize()
    for rate in [float(r) for r in args.rates.split(",")]:
        schedule = traffic.open_loop(dict(cell["traffic"], rate_per_s=rate), args.seed,
                                     args.seconds)
        run.spans.clear()
        latency = driver.serve(run, predictor, pools, schedule)[0]
        third = len(latency) // 3
        service = [b - a for a, b in run.spans["predict"]]
        print(json.dumps(dict(
            rate_per_s=rate, requests=len(latency), p50_ms=1e3 * statistics.median(latency),
            p95_ms=1e3 * driver.percentile(latency, 95), max_ms=1e3 * max(latency),
            first_third_p50_ms=1e3 * statistics.median(latency[:third]),
            last_third_p50_ms=1e3 * statistics.median(latency[-third:]),
            service_p50_ms=1e3 * statistics.median(service))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
