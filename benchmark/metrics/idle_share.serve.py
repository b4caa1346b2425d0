"""The traced window's time in which no device operation ran (the union
of the operations' intervals taken out)."""
LAYER, UNIT, BETTER, MOVES = "Device", "%", "lower", "slices_per_s"


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
