"""Host time in ``Evaluator.predict_on_dataset`` (decode, resize, the
model and its decode, the drain) per image scored."""


def read(run):
    from perfbench.harness import span_ms

    images = run.values.get("scored")
    return sum(span_ms(run, "predict")) / images if images else None
