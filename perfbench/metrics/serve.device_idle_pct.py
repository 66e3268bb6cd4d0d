"""Share of the traced window with nothing running on the card."""


def read(run):
    from perfbench.harness import idle_pct

    return idle_pct(run)
