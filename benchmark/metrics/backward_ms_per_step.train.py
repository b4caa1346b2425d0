"""Device time of the operations the autograd engine launched (its own
threads: every backward op, the custom ops' backward kernels among them),
per training step."""
LAYER, UNIT, BETTER, MOVES = "Autograd ops", "ms", "lower", \
    "train_samples_per_s"


def read(ctx):
    s = ctx.trace.engine_s()
    return s / ctx.traced["steps"] * 1e3 if s > 0 else None
