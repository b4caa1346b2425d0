"""Host time of the training step's glue around the model, per step:
``train_step.prepare`` (LR and weight-decay writes, zero_grad, the
encoder's requires_grad toggles) and ``train_step.fill`` (missing
gradients zero-filled)."""
from benchmark import spans

LAYER, UNIT, BETTER, MOVES = "Trainer", "ms", "lower", "train_samples_per_s"


def read(ctx):
    return spans.per_step_ms(ctx, "train_step.prepare", "train_step.fill")
