"""Median host time of an ``SSDPredictor.predict`` call (queue excluded)."""

import statistics


def read(run):
    from perfbench.harness import span_ms

    times = span_ms(run, "predict")
    return statistics.median(times) if times else None
