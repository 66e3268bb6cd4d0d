"""Host time of the evaluator's ``eval.bucket`` spans (inverse transforms
and the per-box loop) over the traced pass, per image predicted
(``eval.images``)."""


def read(run):
    from perfbench import program

    images = program.counts(run).get("eval.images")
    spans = program.program_s(run)
    return 1e3 * program.total_s(spans, "eval.bucket") / images if images and spans else None
