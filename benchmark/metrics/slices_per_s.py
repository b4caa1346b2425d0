"""Real (unpadded) slices of every volume the window completed, over the
window's whole time (its last volume ends it)."""
UNIT, BETTER = "slices/s", "higher"


def read(ctx):
    r = ctx.record
    return r["slices"] / r["window_s"] if "slices" in r else None
