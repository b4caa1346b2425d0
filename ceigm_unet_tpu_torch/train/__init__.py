"""Training: configuration presets, LR schedules, the training step and
the epoch loop."""
