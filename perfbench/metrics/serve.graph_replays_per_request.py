"""CUDA graph launches on the host (``cudaGraphLaunch`` in the profiler's
trace) per request begun in the traced window."""


def read(run):
    requests = len(run.traced_spans("predict"))
    if run.traced is None or not requests:
        return None
    return run.traced["host_calls"].get("cudaGraphLaunch", 0) / requests
