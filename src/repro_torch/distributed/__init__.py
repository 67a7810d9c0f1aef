"""Port of repro.distributed."""
