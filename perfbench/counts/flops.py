"""FLOPs of SSD300/SSD512 from their layer shapes: 2 a multiply-add of
every convolution (the heads included); pools, ReLU, the L2 norm and the
softmax count nothing, as ``torch.utils.flop_counter`` counts them."""

from __future__ import annotations

from perfbench.reference.ssd import conv_table, feature_sizes


def conv_flops(config: dict) -> dict:
    """Forward FLOPs of one image, by convolution."""
    sizes = feature_sizes(config)
    out = {}
    for name, cin, cout, k, _, _, _ in conv_table(config):
        src = name.rsplit("_mbox_", 1)[0] if "_mbox_" in name else name
        h, w = sizes[src]
        out[name] = 2 * cin * cout * k * k * h * w
    return out


def forward_flops(config: dict) -> int:
    """Forward FLOPs of one image."""
    return sum(conv_flops(config).values())


def train_flops(config: dict) -> int:
    """Forward and backward FLOPs of one image with no recomputation: each
    convolution's weight gradient and input gradient cost its forward
    again, except the input gradient of the first, which nothing needs."""
    per = conv_flops(config)
    first = next(iter(per))
    return 3 * sum(per.values()) - per[first]
