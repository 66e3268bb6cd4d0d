"""Share of the traced window in which the card was idle while the
predictor was in a host stage: ``program_idle_s`` under the ``predict.*``
spans other than ``predict.read``, and ``predict`` itself, over the window.
Needs ``program_idle_s`` (``perfbench.program``)."""

STAGES = ("predict", "predict.prepare", "predict.weights_check", "predict.capture",
          "predict.stack", "predict.pin", "predict.launch", "predict.finish")


def read(run):
    from perfbench import program

    return program.idle_pct_under(run, STAGES)
