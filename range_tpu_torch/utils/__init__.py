"""Training utilities: meters, metrics files, checkpoints."""
