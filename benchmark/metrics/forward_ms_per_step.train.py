"""Device time of the operations launched inside the model's forward
(forward hooks), per training step."""
LAYER, UNIT, BETTER, MOVES = "Model", "ms", "lower", "train_samples_per_s"


def read(ctx):
    s = ctx.trace.range_s("bench.forward")
    return s / ctx.traced["steps"] * 1e3 if s > 0 else None
