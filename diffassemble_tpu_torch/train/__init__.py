"""Training: Adafactor, train state and step, metrics, checkpoints, the trainer."""
