"""Median time on the card's stream between the CUDA events the harness
records around each train step (forward, loss, backward, update)."""


def read(run):
    return run.values.get("step_ms")
