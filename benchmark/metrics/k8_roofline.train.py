"""K8 (scan2d, csrc/scan2d.cu): the least time the card could take for
every K8 launch of the traced window (a and b read and h written once, in
fp32, over the HBM bandwidth; two launches per quad block and unfrozen
step) over the device time those launches took. Read only where the trace
and the program's launch counter both hold that many launches."""
from benchmark import flops

LAYER, UNIT, BETTER, MOVES = "Hand-written kernels", "%", "higher", \
    "train_samples_per_s"


def is_k8(name: str) -> bool:
    return "scan2d_kernel" in name


def read(ctx):
    t, n = ctx.trace, ctx.traced
    blocks = flops.quad_blocks(ctx.config, ctx.mix["img"])
    launches = 2 * len(blocks) * n["steps"]
    if t.count(is_k8) != launches or n["launches"].get("scan2d", 0) != launches:
        return None
    bound = 2 * n["steps"] * sum(flops.bound_seconds(flops.k8_bytes(
        n["batch"], side, c)) for side, c in blocks)
    return 100.0 * bound / t.device_s(is_k8)
