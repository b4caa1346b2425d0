"""Device time of the host-to-device and device-to-host copies per served
batch (the slices' upload, the class maps' download, the zoom operators'
uploads)."""
LAYER, UNIT, BETTER, MOVES = "Entry / serving", "ms", "lower", "slices_per_s"


def read(ctx):
    t, n = ctx.trace, ctx.traced
    s = t.device_s(lambda name: name.startswith(("Memcpy HtoD",
                                                 "Memcpy DtoH")))
    return s / n["batches"] * 1e3 if s > 0 else None
