"""Samples of every step the window ran, over the window's time; the
window ends when the card has finished them."""
UNIT, BETTER = "samples/s", "higher"


def read(ctx):
    r = ctx.record
    return r["samples"] / r["window_s"] if "samples" in r else None
