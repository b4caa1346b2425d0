"""Forward and backward matrix FLOPs (3 x the forward's, by the
architecture's shapes) of the samples the traced window stepped, over the
window's time, against the card's peak in the cell's compute dtype (bf16
989 TFLOP/s; fp32 67 TFLOP/s outside the tensor cores)."""
from benchmark import flops

LAYER, UNIT, BETTER, MOVES = "Device", "%", "higher", "train_samples_per_s"


def read(ctx):
    n = ctx.traced
    work = 3 * n["steps"] * n["batch"] * flops.forward_flops(
        ctx.config, ctx.mix["img"])
    return 100.0 * work / ctx.trace.window_s / flops.PEAK_FLOPS[
        ctx.mix["dtype"]]
