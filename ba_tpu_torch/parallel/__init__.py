"""Distribution over `torch.distributed`: the communicator (`mesh`), the
landmark partition (`partition`), the sharded solves and fleets (`shard`)
and the multi-process glue (`multihost`)."""
