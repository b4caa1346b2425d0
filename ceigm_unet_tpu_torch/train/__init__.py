"""Training: configuration presets, LR schedules, the training step."""
