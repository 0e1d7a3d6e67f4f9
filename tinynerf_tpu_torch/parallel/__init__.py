"""Data and sample parallelism over torch.distributed process groups."""
