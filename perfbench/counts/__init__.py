"""The benchmark's own arithmetic of work: FLOPs from a configuration's
layer shapes (``flops.py``) and the peaks and roofline bounds of the
hand-written kernels (``roofline.py``)."""
