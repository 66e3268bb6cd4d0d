"""Spawn the ranks of a data-parallel run on one machine, with time limits.

:func:`run_ranks` starts ``world_size`` fresh processes (``spawn``), joins
each to one gloo process group through a ``FileStore`` in a temporary
directory (no port is needed), runs ``worker(rank, *args)`` in each and
returns their results in rank order. A rank that raises, dies or outlives
the time limit fails the whole run: the other ranks, which may be waiting
in a collective for it, are killed, and the error names the rank and
carries its traceback. Nothing falls back to fewer ranks.

The worker must be importable by its module path (a module-level function
of a module that imports no JAX, so that the children start quickly and run
where JAX is not installed); its arguments and result are pickled.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from ssd_keras_torch.parallel.sharding import initialize_distributed

__all__ = ["run_ranks"]


def _rank_main(worker, rank, world_size, store_path, args, results):
    try:
        torch.set_num_threads(1)  # the ranks share the machine's cores
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        initialize_distributed("gloo", world_size, rank, init_method=f"file://{store_path}")
        try:
            value = worker(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:  # reported to the parent, then the rank exits non-zero
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(worker: Callable, world_size: int, args: Sequence[Any] = (),
              timeout: float = 300.0) -> List[Any]:
    """Run ``worker(rank, *args)`` in ``world_size`` spawned ranks of one
    gloo process group; return the results in rank order. gloo runs the
    port's collectives on CPU and on CUDA tensors, so ranks may share a
    card.

    ``timeout`` bounds the whole run in seconds; each collective has the
    process group's own (``sharding.DEFAULT_TIMEOUT``). Each rank uses one
    intra-op thread and, where there are CUDA devices, device
    ``rank % device_count``. Raises ``RuntimeError`` when a rank fails and
    ``TimeoutError`` when the run outlives ``timeout``.
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got, errors = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(worker, rank, world_size, store, tuple(args), results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            # Read every result before joining: a child blocks on exit until
            # the queue's pipe has been drained.
            while len(got) + len(errors) < world_size and not errors:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    # A rank puts its result or its traceback before it exits,
                    # so one that died with nothing queued was killed.
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead and results.empty():
                        r = dead[0]
                        errors[r] = f"rank {r} exited with code {procs[r].exitcode} and no result"
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world_size} ranks of {getattr(worker, '__name__', worker)} did "
                            f"not finish in {timeout:.0f} s (finished: {sorted(got)})")
                    continue
                (got if ok else errors)[rank] = value
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())) if not errors else 1.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
    if errors:
        rank = min(errors)
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n{errors[rank]}")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with (rank, code) {bad}")
    return [got[r] for r in range(world_size)]
