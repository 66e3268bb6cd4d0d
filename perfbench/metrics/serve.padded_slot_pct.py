"""Share of the predictor's batch slots over the traced window that held
padding: ``predict.slots`` (chunks x the batch size) less
``predict.images``, over ``predict.slots``."""


def read(run):
    from perfbench import program

    counts = program.counts(run)
    slots = counts.get("predict.slots")
    return 100.0 * (slots - counts.get("predict.images", 0)) / slots if slots else None
