"""K1 (quad_scan_ln, csrc/quad_scan_ln.cu): the least time the card could
take for every K1 launch of the traced window (the bytes the launch's
shape needs, read and written once, over the HBM bandwidth) over the
device time those launches took. Read only where the trace holds one
launch per quad block of every forward and the program's own launch
counter agrees."""
from benchmark import flops

LAYER, UNIT, BETTER, MOVES = "Hand-written kernels", "%", "higher", \
    "slices_per_s"
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def is_k1(name: str) -> bool:
    return "quad_scan_ln_kernel" in name


def read(ctx):
    t, n = ctx.trace, ctx.traced
    blocks = flops.quad_blocks(ctx.config, ctx.mix["patch"][0])
    launches = len(blocks) * n["forwards"]
    if t.count(is_k1) != launches or \
            n["launches"].get("quad_scan_ln", 0) != launches:
        return None
    bound = n["forwards"] * sum(flops.bound_seconds(flops.k1_bytes(
        n["batch"], side, c, ITEMSIZE[ctx.mix["dtype"]])) for side, c in blocks)
    return 100.0 * bound / t.device_s(is_k1)
