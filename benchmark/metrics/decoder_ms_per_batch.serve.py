"""Device time of the operations launched inside the model's decoder
(forward hooks), per served batch."""
LAYER, UNIT, BETTER, MOVES = "Model", "ms", "lower", "slices_per_s"


def read(ctx):
    s = ctx.trace.range_s("bench.decoder")
    return s / ctx.traced["forwards"] * 1e3 if s > 0 else None
