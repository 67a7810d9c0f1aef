"""Port of repro.data."""
