"""Host time of the optimizer's step inside the training step (the span
``train_step.optimizer``), per step."""
from benchmark import spans

LAYER, UNIT, BETTER, MOVES = "Trainer", "ms", "lower", "train_samples_per_s"


def read(ctx):
    return spans.per_step_ms(ctx, "train_step.optimizer")
