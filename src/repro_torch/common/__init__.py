"""repro_torch.common: the sharding rules and tree helpers."""
