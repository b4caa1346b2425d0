"""From the start of the run's script to the window's start: imports, the
kernels' build (first run in a checkout) and load, the model, weights and
inputs made from the seed, the warm-up of the cell's shapes (and, in the
training cells, the checked first steps)."""
UNIT, BETTER = "s", "lower"


def read(ctx):
    return ctx.setup_s
