"""The zero slices predict_volume added to fill each volume's last batch,
as a share of every slice it computed, over the traced window's volumes
(the counts ``padded`` and ``slices`` of its ``predict_volume`` spans)."""
from benchmark import spans

LAYER, UNIT, BETTER, MOVES = "Entry / serving", "%", "lower", "slices_per_s"


def read(ctx):
    found = spans.volumes(ctx)
    if found is None:
        return None
    vols = found[1]
    padded = sum(v["counts"]["padded"] for v in vols)
    return 100.0 * padded / (ctx.traced["slices"] + padded)
