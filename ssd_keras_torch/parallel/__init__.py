"""Data parallelism over ``torch.distributed`` ranks (``sharding``), rank
launching (``launch``) and the data-parallel dry run (``dryrun``)."""

from ssd_keras_torch.parallel.sharding import (
    global_batch_from_local,
    initialize_distributed,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "global_batch_from_local",
    "initialize_distributed",
    "make_mesh",
    "replicate",
    "shard_batch",
]
