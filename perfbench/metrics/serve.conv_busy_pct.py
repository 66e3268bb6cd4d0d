"""The convolutions' share of the card's busy time over the traced window:
the device time of the kernels whose names mark a convolution, over the
time anything ran on the card (``busy_s``).

A kernel is a convolution's where its name, in lower case, holds "fprop"
(cuDNN's and CUTLASS's forward-propagation kernels, such as
``sm90_xmma_fprop_implicit_gemm_*`` and ``cutlass_tensorop_*fprop*``) or
"conv" not followed by "ert" (cuDNN's ``*conv*`` kernels, not a
``convert`` kernel)."""

import re

CONV = re.compile(r"fprop|conv(?!ert)")


def read(run):
    if run.traced is None or run.traced["busy_s"] <= 0:
        return None
    conv = sum(s for k, s in run.traced["kernel_s"].items() if CONV.search(k.lower()))
    return 100.0 * conv / run.traced["busy_s"]
