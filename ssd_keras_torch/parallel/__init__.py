"""Data parallelism over ``torch.distributed`` ranks (``sharding``), rank
launching (``launch``) and the data-parallel dry run (``dryrun``)."""
