"""Host time in the evaluator's matching, precision/recall, AP and mAP per
image scored."""


def read(run):
    from perfbench.harness import span_ms

    images = run.values.get("scored")
    return sum(span_ms(run, "score")) / images if images else None
