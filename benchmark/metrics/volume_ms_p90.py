"""90th percentile, over every volume the window completed, of the time
from the call into predict_volume to the class map on the host."""
import numpy as np

UNIT, BETTER = "ms", "lower"


def read(ctx):
    lat = ctx.record.get("latency_s")
    return float(np.percentile(lat, 90)) * 1e3 if lat else None
