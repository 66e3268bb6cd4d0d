"""Median time on the card's stream between the CUDA events the harness
records around its call into augment + encode, per batch of the window."""


def read(run):
    return run.values.get("input_ms")
