"""Domain decomposition: ``DistributedModel`` over a mesh of shards, the
halo exchange, the pencil Poisson solvers and MultiRegion."""
