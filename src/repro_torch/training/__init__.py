"""Port of repro.training."""
