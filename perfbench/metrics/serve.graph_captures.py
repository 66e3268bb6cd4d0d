"""CUDA graphs the predictor captured over the traced window
(``predict.graph_captures``): 0 once every shape is warm."""


def read(run):
    from perfbench import program

    counts = program.counts(run)
    if not counts.get("predict.requests"):
        return None
    return counts.get("predict.graph_captures", 0)
