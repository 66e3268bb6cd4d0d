from ssd_keras_torch.ops import anchors, boxes, matching, nms  # noqa: F401
