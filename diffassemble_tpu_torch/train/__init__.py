"""Training: Adafactor, train state and step, metrics, checkpoints, the trainer, LR schedules."""

from .schedules_lr import cosine_annealing_warmup_restarts  # noqa: F401
