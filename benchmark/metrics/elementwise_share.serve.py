"""PyTorch's elementwise, reduction and LayerNorm kernels (at::native
kernels named elementwise, reduce or layer_norm): their share of the
device time in the traced window."""
LAYER, UNIT, BETTER, MOVES = "Torch ops", "%", "lower", "slices_per_s"


def is_elementwise(name: str) -> bool:
    low = name.lower()
    return "at::native" in name and any(
        w in low for w in ("elementwise", "reduce", "layer_norm"))


def read(ctx):
    total = ctx.trace.device_s()
    return 100.0 * ctx.trace.device_s(is_elementwise) / total if total else None
