"""FLOPs of an SSD network from its layer shapes: 2 a multiply-add of
every convolution in the architecture's table (the heads included); pools,
ReLU, norms and the softmax count nothing, as ``torch.utils.flop_counter``
counts them."""

from __future__ import annotations

from perfbench.reference.ssd import conv_table, feature_sizes


def conv_flops(config: dict) -> dict:
    """Forward FLOPs of one image, by convolution."""
    sizes = feature_sizes(config)
    out = {}
    for name, cin, cout, k, _, _, _ in conv_table(config):
        h, w = sizes[name]
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
