"""Share of the traced epoch in which the card was idle while the step's
host code ran: ``program_idle_s`` under ``train.forward``, ``.loss``,
``.backward`` and ``.optimizer``, over the window. Needs
``program_idle_s`` (``perfbench.program``)."""

STAGES = ("train.forward", "train.loss", "train.backward", "train.optimizer")


def read(run):
    from perfbench import program

    return program.idle_pct_under(run, STAGES)
