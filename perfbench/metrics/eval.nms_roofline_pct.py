"""The NMS kernel's (``csrc/nms.cu``: ``nms_iou_mask``, ``nms_resolve``)
device time over the traced pass against the least time the work of that
pass's lanes needs (``counts.roofline.nms_bound`` on the reference's
candidates of the same images): bound by operations on these lanes."""


def read(run):
    from perfbench.harness import kernel_seconds

    spent = kernel_seconds(run, "nms_iou_mask", "nms_resolve")
    bound = run.values.get("nms_bound_s")
    return 100.0 * bound / spent if spent > 0 and bound else None
