"""Checkpoints (the trainer comes with the training slice)."""
