"""Training: loss, optimizer state, train step, checkpoints."""
