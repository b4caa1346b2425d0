"""The architecture's matrix FLOPs of the real (unpadded) slices served in
the traced window, over the window's time, against the card's peak in the
cell's compute dtype (benchmark/flops.py)."""
from benchmark import flops

LAYER, UNIT, BETTER, MOVES = "Device", "%", "higher", "slices_per_s"


def read(ctx):
    work = ctx.traced["slices"] * flops.forward_flops(ctx.config,
                                                     ctx.mix["patch"][0])
    return 100.0 * work / ctx.trace.window_s / flops.PEAK_FLOPS[
        ctx.mix["dtype"]]
