"""Checkpoints and logging."""
