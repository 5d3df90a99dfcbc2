"""Sharding of the port's model over a ``torch.distributed`` device mesh."""
