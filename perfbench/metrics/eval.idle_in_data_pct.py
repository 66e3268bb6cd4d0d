"""Share of the traced pass in which the card was idle while the data
generator ran: ``program_idle_s`` under ``data.*``, over the window. Needs
``program_idle_s`` (``perfbench.program``)."""

STAGES = ("data.batch", "data.read", "data.decode", "data.transform", "data.collate")


def read(run):
    from perfbench import program

    return program.idle_pct_under(run, STAGES)
