"""The sharded layer on torch.distributed: one process per rank, each rank
holding its shard of the record (or op) axis as local tensors on its own
device.  NCCL on the card, gloo on the CPU."""
