"""The images served over the window (padding excluded) at the SSD300
forward's FLOPs (``counts.flops``), as a share of the bf16 peak."""


def read(run):
    from perfbench.counts.flops import forward_flops
    from perfbench.harness import mfu_pct

    return mfu_pct(run, forward_flops(run.config))
