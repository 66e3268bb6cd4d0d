"""The images trained over the window at SSD300's forward and backward
FLOPs (``counts.flops.train_flops``), as a share of the bf16 peak."""


def read(run):
    from perfbench.counts.flops import train_flops
    from perfbench.harness import mfu_pct

    return mfu_pct(run, train_flops(run.config))
