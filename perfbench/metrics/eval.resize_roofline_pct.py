"""The resize kernel's (``csrc/resize_linear.cu``: ``resize_linear_u8``)
device time over the traced pass against the least time its bytes need:
each image of the pass read once (H x W x 3) and its output written once
(img_height x img_width x 3), at ``counts.roofline.HBM_BYTES_PER_S``. The
pass's images are the cell's shapes in its proportions, as
``traffic.jpeg_test_set`` makes them. Bound by bytes. None where the
program has no such kernel."""


def read(run):
    from perfbench.counts.roofline import HBM_BYTES_PER_S
    from perfbench.harness import kernel_seconds

    spent = kernel_seconds(run, "resize_linear_u8")
    if spent <= 0:
        return None
    p, config = run.cell["traffic"], run.config
    out = 3 * config["img_height"] * config["img_width"]
    left, nbytes = p["images"], 0
    for (h, w), share in zip(p["shapes"], p["shares"]):
        k = min(int(round(share * p["images"])), left)
        nbytes += k * (3 * h * w + out)
        left -= k
    return 100.0 * nbytes / HBM_BYTES_PER_S / spent
