"""Host time inside predict_volume's two whole-volume copies, per served
volume: the padding of the last batch (``predict_volume.pad``) and the
join of the class maps cut to the volume's depth, with the release of
the batches' maps and the padded copy (``predict_volume.gather``); the
program's spans."""
from benchmark import spans

LAYER, UNIT, BETTER, MOVES = "Entry / serving", "ms", "lower", "slices_per_s"


def read(ctx):
    found = spans.volumes(ctx)
    if found is None:
        return None
    recs, vols = found
    pad = spans.named(recs, "predict_volume.pad")
    gather = spans.named(recs, "predict_volume.gather")
    if len(pad) != len(vols) or len(gather) != len(vols):
        return None
    return spans.host_ms(pad + gather) / len(vols)
