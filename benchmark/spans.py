"""The program's own spans (``ceigm_unet_tpu_torch/utils/spans.py``) as the
per-layer readers take them: the records of the traced window, checked
against what the traffic counted there (``ctx.traced``). ``records``,
``volumes`` and ``per_step_ms`` return None where there is nothing to read:
a program without the recorder, or spans that disagree with the traffic's
counts."""
from __future__ import annotations

import importlib
from typing import Dict, Iterable, List, Optional, Tuple


def records() -> Optional[List[Dict]]:
    try:
        spans = importlib.import_module("ceigm_unet_tpu_torch.utils.spans")
    except ImportError:
        return None
    return spans.records()


def named(recs: Iterable[Dict], *names: str) -> List[Dict]:
    return [r for r in recs if r["name"] in names]


def host_ms(recs: Iterable[Dict]) -> float:
    return sum(r["end_ns"] - r["start_ns"] for r in recs) * 1e-6


def volumes(ctx) -> Optional[Tuple[List[Dict], List[Dict]]]:
    """(every record, the ``predict_volume`` records), or None unless the
    volumes, their slices and their batches are those the traffic served
    in the traced window."""
    recs = records()
    if not recs:
        return None
    vols, n = named(recs, "predict_volume"), ctx.traced
    if len(vols) != n["volumes"] or \
            sum(v["counts"]["slices"] for v in vols) != n["slices"] or \
            sum(v["counts"]["batches"] for v in vols) != n["batches"]:
        return None
    return recs, vols


def per_step_ms(ctx, *names: str) -> Optional[float]:
    """Host ms of the spans ``names`` per training step, or None unless
    the trace holds one ``train_step`` of the traffic's batch, and one of
    each of ``names``, per step the traffic ran."""
    recs = records()
    if not recs:
        return None
    steps, n = named(recs, "train_step"), ctx.traced["steps"]
    if len(steps) != n or any(s["counts"]["samples"] != ctx.traced["batch"]
                              for s in steps):
        return None
    picked = named(recs, *names)
    if len(picked) != n * len(names):
        return None
    return host_ms(picked) / n
