"""Host time of the data generator's ``data.transform`` spans (the
transformation chain: RGB, the host resize) over the traced pass, per image
predicted (``eval.images``)."""


def read(run):
    from perfbench import program

    images = program.counts(run).get("eval.images")
    spans = program.program_s(run)
    return 1e3 * program.total_s(spans, "data.transform") / images if images and spans else None
