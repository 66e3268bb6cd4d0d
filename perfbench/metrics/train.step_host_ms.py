"""Host time of ``Trainer``'s ``train.step`` spans less their
``train.next_batch`` (the input's own time) over the traced epoch, per
step (``train.steps``): preparing, and enqueueing forward, loss, backward
and the update."""


def read(run):
    from perfbench import program

    spans, steps = program.program_s(run), program.counts(run).get("train.steps")
    if not steps or "train.step" not in spans:
        return None
    return 1e3 * (program.total_s(spans, "train.step")
                  - program.total_s(spans, "train.next_batch")) / steps
