"""torch.cuda.max_memory_allocated over the window, reset after set-up."""
UNIT, BETTER = "GiB", "lower"


def read(ctx):
    b = ctx.record.get("peak_bytes")
    return b / 2 ** 30 if b else None
