"""repro_torch.parallel: the sharding rules and the collectives of sharded
serving."""
