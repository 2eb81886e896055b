"""The sharded trainer: graph partition, halo exchange over torch.distributed."""
