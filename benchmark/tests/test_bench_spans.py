"""The readers of the program's spans: each reads hand-built records
against the traffic's counts, gives nothing where the two disagree or the
program has no recorder, and a traced run at the gm_test widths reports
them."""
import itertools
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark import spans as bench_spans
from benchmark.tests.conftest import TINY_CONFIG, TINY_TRAIN, TINY_VOLUMES

MS = 1_000_000          # ns


def _rec(ids, name, start_ms, end_ms, parent=None, request=0, **counts):
    return {"name": name, "id": next(ids), "parent": parent,
            "request": request, "start_ns": start_ms * MS,
            "end_ns": end_ms * MS, "counts": counts}


def _volumes():
    """Two volumes: 5 slices at batch 4 (2 batches, 3 padded), 4 slices
    (1 batch, none padded)."""
    ids, recs = itertools.count(), []
    t = 0
    for v, (slices, padded, batches) in enumerate(((5, 3, 2), (4, 0, 1))):
        top = _rec(ids, "predict_volume", t, t + 100, request=v,
                   slices=slices, padded=padded, batches=batches)
        recs += [top, _rec(ids, "predict_volume.pad", t, t + 2 + v,
                           top["id"], v)]
        for _ in range(batches):
            model = _rec(ids, "predict_volume.model", t + 10, t + 40,
                         top["id"], v)
            recs += [model, _rec(ids, "derive.ss2d", t + 11, t + 12,
                                 model["id"], v)]
        recs.append(_rec(ids, "predict_volume.gather", t + 90, t + 94,
                         top["id"], v))
        t += 200
    traced = {"volumes": 2, "slices": 9, "batches": 3, "forwards": 3,
              "batch": 4}
    return recs, traced


def _steps():
    """Two steps of 4 samples."""
    ids, recs = itertools.count(), []
    for s in range(2):
        t = 1000 * s
        top = _rec(ids, "train_step", t, t + 500 + s * 100, request=s,
                   samples=4)
        recs.append(top)
        for name, a, b in (("train_step.prepare", 0, 3),
                           ("train_step.forward", 3, 100),
                           ("train_step.loss", 100, 110),
                           ("train_step.backward", 110, 400),
                           ("train_step.fill", 400, 405),
                           ("train_step.reduce", 405, 406),
                           ("train_step.optimizer", 406, 480 + s * 20)):
            recs.append(_rec(ids, name, t + a, t + b, top["id"], s))
    return recs, {"steps": 2, "batch": 4}


CASES = {
    "host_copy_ms_per_volume.serve": (_volumes, (2 + 4 + 3 + 4) / 2),
    "padded_share.serve": (_volumes, 100.0 * 3 / 12),
    "step_host_ms.train": (_steps, (500 + 600) / 2),
    "optimizer_host_ms.train": (_steps, (74 + 94) / 2),
    "step_glue_host_ms.train": (_steps, (3 + 5) * 2 / 2),
}


def _read(monkeypatch, name, recs, traced):
    monkeypatch.setattr(bench_spans, "records", lambda: recs)
    return harness.metric(name).read(SimpleNamespace(traced=traced))


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_reads_the_spans(monkeypatch, name):
    make, want = CASES[name]
    recs, traced = make()
    assert _read(monkeypatch, name, recs, traced) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_reads_nothing_where_the_counts_disagree(monkeypatch, name):
    make, _ = CASES[name]
    recs, traced = make()
    unit = "volumes" if "volumes" in traced else "steps"
    assert _read(monkeypatch, name, recs,
                 {**traced, unit: traced[unit] + 1}) is None
    assert _read(monkeypatch, name, [], traced) is None


@pytest.mark.parametrize("name,drop", [
    ("host_copy_ms_per_volume.serve", "predict_volume.gather"),
    ("optimizer_host_ms.train", "train_step.optimizer"),
    ("step_glue_host_ms.train", "train_step.fill")])
def test_reader_reads_nothing_where_a_span_is_missing(monkeypatch, name,
                                                      drop):
    recs, traced = CASES[name][0]()
    lost = next(i for i, r in enumerate(recs) if r["name"] == drop)
    assert _read(monkeypatch, name, recs[:lost] + recs[lost + 1:],
                 traced) is None


def test_serving_counts_are_checked(monkeypatch):
    recs, traced = _volumes()
    for key in ("slices", "batches"):
        assert _read(monkeypatch, "padded_share.serve", recs,
                     {**traced, key: traced[key] - 1}) is None
    steps, st = _steps()
    assert _read(monkeypatch, "step_host_ms.train", steps,
                 {**st, "batch": 8}) is None


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "ceigm_unet_tpu_torch.utils.spans",
                        None)
    assert bench_spans.records() is None
    recs, traced = _volumes()
    for name in CASES:
        ctx = SimpleNamespace(traced=traced if name.endswith(".serve")
                              else _steps()[1])
        assert harness.metric(name).read(ctx) is None


@pytest.mark.parametrize("cell,mix", [
    ("gm_tiny.volumes_bf16_b128", TINY_VOLUMES),
    ("gm_tiny.train_fp32_b48", TINY_TRAIN)])
def test_a_traced_run_reports_the_span_metrics(cell, mix):
    result = harness.run_cell(harness.workload(cell), TINY_CONFIG, mix,
                              2 ** 31 + 7, 0.2, True, torch.device("cpu"),
                              harness.spec(), 0.0,
                              log=lambda *a, **k: None)[0]
    got = result["metrics"]
    if cell.endswith("b128"):
        assert got["host_copy_ms_per_volume.serve"]["value"] > 0
        assert 0 <= got["padded_share.serve"]["value"] < 100
    else:
        step = got["step_host_ms.train"]["value"]
        assert step > got["optimizer_host_ms.train"]["value"] > 0
        assert step > got["step_glue_host_ms.train"]["value"] > 0
