"""A callable captured as a CUDA graph over a static input, and replayed.

:class:`CapturedGraph` is the port's one capture: the predictor's graph of
each input shape (``predictor.py``) and the entry's captured forward
(``graft_entry.CapturedForward``) are uses of it. It knows no kernel and
no model. The counts (``utils.profiling.count``) that the captured calls
make, the kernels' launches among them, are held at capture and counted
again at each replay, when those launches happen.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from ssd_keras_torch.utils.profiling import count_all, held

__all__ = ["CapturedGraph", "WARMUP_CALLS"]

# Eager calls on the capture stream before the capture: they fill what the
# callable makes once and keeps (a model's constants and kept bf16 weights,
# a kernel's scratch for that stream, the libraries' handles), so the
# capture records no copy from the host, no cast and no allocation outside
# the graph's own pool.
WARMUP_CALLS = 1


class CapturedGraph:
    """``fn(static_in)`` captured as a CUDA graph on ``stream``, after
    ``WARMUP_CALLS`` eager calls there, all under inference mode.

    A graph reads by raw pointer what lies outside its private pool.
    ``keep_alive`` is called after the warm-up and its tensors are kept for
    as long as the graph lives, so a graph never reads freed memory; the
    caller must not change them in place while it lives. ``counts`` holds
    the counts the capture made (``name -> n``).
    """

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], static_in: torch.Tensor,
                 stream: torch.cuda.Stream,
                 keep_alive: Callable[[], Iterable[torch.Tensor]]):
        self.static_in = static_in
        current = torch.cuda.current_stream(static_in.device)
        stream.wait_stream(current)
        with torch.inference_mode(), torch.cuda.stream(stream):
            for _ in range(WARMUP_CALLS):
                fn(static_in)
            self.graph = torch.cuda.CUDAGraph()
            with held() as self.counts, torch.cuda.graph(self.graph, stream=stream):
                self.static_out = fn(static_in)
        current.wait_stream(stream)
        self.keep_alive = list(keep_alive())

    def __call__(self, x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Copy ``x`` in (if given; a pinned host tensor is copied without a
        wait), replay on the current stream, count the held counts, and
        return a copy of the output (the next replay overwrites the static
        one while this one may still be in flight)."""
        with torch.inference_mode():
            if x is not None:
                self.static_in.copy_(x, non_blocking=True)
            self.graph.replay()
            out = self.static_out.clone()
        count_all(self.counts)
        return out
