"""The JPEG colour kernel's (``csrc/jpeg_color.cu``: ``ycc_to_rgb``) device
time over the traced pass against the least time its bytes need (each
plane read once and the pixels written once, ``counts.roofline``): bound
by bytes."""


def read(run):
    from perfbench.harness import kernel_seconds

    spent = kernel_seconds(run, "ycc_to_rgb")
    bound = run.values.get("jpeg_color_bound_s")
    return 100.0 * bound / spent if spent > 0 and bound else None
