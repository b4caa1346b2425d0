"""Device time of the operations launched inside the optimizer's step
(its step hooks), per training step."""
LAYER, UNIT, BETTER, MOVES = "Trainer", "ms", "lower", "train_samples_per_s"


def read(ctx):
    s = ctx.trace.range_s("bench.optimizer")
    return s / ctx.traced["steps"] * 1e3 if s > 0 else None
