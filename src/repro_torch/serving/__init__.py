"""Port of repro.serving."""
