"""Evaluation: render sets from a checkpoint, score them, track."""
