"""Data parallelism over torch.distributed (`mesh`), the chopped forward
(`chop`) and halo-exchange spatial sharding (`halo`)."""
