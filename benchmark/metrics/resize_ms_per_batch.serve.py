"""Device time of the kernels launched inside the cubic zoom in and the
nearest zoom back, per served batch (copies left out)."""
LAYER, UNIT, BETTER, MOVES = "Resize", "ms", "lower", "slices_per_s"


def read(ctx):
    kernel = lambda name: not name.startswith(("Memcpy", "Memset"))
    s = sum(ctx.trace.range_s(r, kernel)
            for r in ("bench.zoom", "bench.zoom_back"))
    return s / ctx.traced["batches"] * 1e3 if s > 0 else None
