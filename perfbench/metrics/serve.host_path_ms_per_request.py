"""Host time of an ``SSDPredictor.predict`` call outside its wait on the
card: the program's ``predict`` spans less their ``predict.read`` spans over
the traced window, per request (``predict.requests``)."""


def read(run):
    from perfbench import program

    spans, requests = program.program_s(run), program.counts(run).get("predict.requests")
    if not requests or "predict" not in spans:
        return None
    return 1e3 * (program.total_s(spans, "predict")
                  - program.total_s(spans, "predict.read")) / requests
