"""The port's spans (``ceigm_unet_tpu_torch/utils/spans.py``) on the CPU at
gm_test widths: off, they record nothing and open no profiler range; under
``torch.profiler`` they record ``predict_volume``'s and the training step's
stages, the weight-derived tensors and the volume's counts, on the
profiler's clock, for the newest profiled window only; and the results are
bitwise those of an unprofiled run."""
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from ceigm_unet_tpu_torch.eval.volume import predict_volume
from ceigm_unet_tpu_torch.models import build_model
from ceigm_unet_tpu_torch.models.emcad import LGAG
from ceigm_unet_tpu_torch.models.layers import CustomFfn
from ceigm_unet_tpu_torch.models.ss2d import QuadGroupSS2D
from ceigm_unet_tpu_torch.train.trainstep import (make_optimizer,
                                                  make_train_step,
                                                  param_groups)
from ceigm_unet_tpu_torch.utils import spans

torch.set_num_threads(1)

PATCH, BATCH = (32, 32), 4
BATCH_STAGES = ["predict_volume.upload", "predict_volume.zoom",
                "predict_volume.model", "predict_volume.argmax",
                "predict_volume.zoom_back", "predict_volume.download"]
STEP_STAGES = ["train_step.prepare", "train_step.forward", "train_step.loss",
               "train_step.backward", "train_step.fill", "train_step.reduce",
               "train_step.optimizer"]
DERIVED = ("derive.ss2d", "derive.ffn", "derive.lgag")


@pytest.fixture(autouse=True)
def fresh_recorder(monkeypatch):
    """Each test starts from a recorder that has recorded nothing."""
    monkeypatch.setattr(spans, "_recorder", spans._Recorder())


@pytest.fixture(scope="module")
def model():
    return build_model(enc_name="gm_test", device="cpu", seed=2).eval()


@pytest.fixture(scope="module")
def volume():
    """5 slices of 40x40: at batch 4, two batches, 3 slices padded."""
    return np.random.default_rng(3).random((5, 40, 40)).astype(np.float32)


def _profiled(fn, *args, **kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args, **kw)
    return out, prof


def _train_setup(device_aug_size=None):
    """A seeded gm_test model in training mode, its step, and a b2 batch
    (raw 40x40 slices where the step augments them to 32x32)."""
    model = build_model(enc_name="gm_test", device="cpu", seed=4).train()
    step = make_train_step(model, make_optimizer(param_groups(model), 1e-3),
                           lambda s: 1e-3, device_aug_size=device_aug_size,
                           aug_seed=5)
    rng = np.random.default_rng(6)
    side = 32 if device_aug_size is None else 40
    batch = {"image": torch.from_numpy(rng.uniform(
                 0, 1, (2, side, side, 1)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 9, (2, side, side)))}
    return model, step, batch


def _run_step(step, batch):
    return step(batch, generator=torch.Generator().manual_seed(1))


def test_off_records_nothing_and_opens_no_range(model, volume, monkeypatch):
    def refused(*a, **k):
        raise AssertionError("record_function opened with the profiler off")
    # the port's view of the profiler (torch's optimizer opens its own
    # ranges whatever the flag says)
    assert not autograd_profiler._is_profiler_enabled
    monkeypatch.setattr(spans, "_profiler", SimpleNamespace(
        _is_profiler_enabled=False, record_function=refused))
    predict_volume(model, volume, PATCH, BATCH)
    _, step, batch = _train_setup()
    _run_step(step, batch)
    assert spans.records() == []


def test_a_profiled_volume_records_its_stages_and_counts(model, volume):
    _, _ = _profiled(predict_volume, model, volume, PATCH, BATCH)
    recs = spans.records()
    top = [r for r in recs if r["name"] == "predict_volume"]
    assert len(top) == 1
    top = top[0]
    assert top["parent"] is None
    assert top["counts"] == {"slices": 5, "padded": 3, "batches": 2}
    children = [r for r in recs if r["parent"] == top["id"]]
    assert [r["name"] for r in children] == \
        BATCH_STAGES * 2 + ["predict_volume.wait", "predict_volume.gather"]
    # the zero fill inside the last batch's upload, once per volume
    uploads = [r for r in children if r["name"] == "predict_volume.upload"]
    pads = [r for r in recs if r["name"] == "predict_volume.pad"]
    assert [r["parent"] for r in pads] == [uploads[-1]["id"]]
    # the map bytes that crossed per batch: 1 a pixel, the narrow path
    assert [r["counts"] for r in children
            if r["name"] == "predict_volume.download"] == \
        [{"bytes": BATCH * 40 * 40}] * 2
    assert all(r["request"] == top["request"] for r in recs)
    assert all(r["start_ns"] <= r["end_ns"] for r in recs)
    # the weight-derived tensors, inside the forwards, once per module
    per_forward = sum(isinstance(m, (QuadGroupSS2D, CustomFfn, LGAG))
                      for m in model.modules())
    derived = [r for r in recs if r["name"] in DERIVED]
    assert len(derived) == 2 * per_forward
    by_id = {r["id"]: r for r in recs}

    def under_model(r):
        while r["parent"] is not None:
            r = by_id[r["parent"]]
            if r["name"] == "predict_volume.model":
                return True
        return False
    assert all(under_model(r) for r in derived)
    assert all(set(r) == {"name", "id", "parent", "request", "start_ns",
                          "end_ns", "counts"} for r in recs)


def test_spans_start_on_the_profilers_clock(model, volume):
    _, prof = _profiled(predict_volume, model, volume, PATCH, BATCH)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    recs = spans.records()
    names = {r["name"] for r in recs}
    events = {}
    for e in prof.events():
        if e.name in names:
            events.setdefault(e.name, []).append(
                t0 + e.time_range.start * 1000)
    for name in names:
        mine = sorted(r["start_ns"] for r in recs if r["name"] == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        gap = max(abs(a - b) for a, b in zip(mine, theirs))
        assert gap < 2_000_000, (name, gap)


@pytest.mark.parametrize("device_aug_size", [None, 32])
def test_a_profiled_step_records_its_stages_in_order(device_aug_size):
    _, step, batch = _train_setup(device_aug_size)
    _run_step(step, batch)
    count = step.count
    _profiled(_run_step, step, batch)
    recs = spans.records()
    top = [r for r in recs if r["name"] == "train_step"]
    assert len(top) == 1
    top = top[0]
    assert top["request"] == count and top["counts"] == {"samples": 2}
    stages = list(STEP_STAGES)
    if device_aug_size is not None:
        stages.insert(1, "train_step.augment")
    assert [r["name"] for r in recs if r["parent"] == top["id"]] == stages
    assert all(r["request"] == count for r in recs)
    assert step.count == count + 1


def test_records_hold_the_newest_profiled_window_only(model, volume):
    _, step, batch = _train_setup()
    _profiled(predict_volume, model, volume, PATCH, BATCH)
    assert any(r["name"] == "predict_volume" for r in spans.records())
    _run_step(step, batch)                       # between two sessions
    _profiled(_run_step, step, batch)
    names = {r["name"] for r in spans.records()}
    assert "train_step" in names
    assert not any(n.startswith("predict_volume") for n in names)


def test_results_are_bitwise_those_of_an_unprofiled_run(model, volume):
    plain = predict_volume(model, volume, PATCH, BATCH)
    traced, _ = _profiled(predict_volume, model, volume, PATCH, BATCH)
    assert plain.dtype == traced.dtype and np.array_equal(plain, traced)
    runs = []
    for on in (False, True):
        m, step, batch = _train_setup()
        out = _profiled(_run_step, step, batch)[0] if on else \
            _run_step(step, batch)
        runs.append((out["loss"], m.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_the_step_holds_no_logits_through_the_backward(monkeypatch):
    """The stages the spans split keep no extra reference: the logits are
    freed before the backward, as in one expression (device memory)."""
    from ceigm_unet_tpu_torch.train import trainstep
    real, seen, refs = trainstep.dice_ce_loss, [], []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, loss):
            return loss.clone()

        @staticmethod
        def backward(ctx, grad):
            seen.append(refs[-1]() is None)
            return grad

    def probed(logits, label, **kw):
        refs.append(weakref.ref(logits))
        return Probe.apply(real(logits, label, **kw))
    monkeypatch.setattr(trainstep, "dice_ce_loss", probed)
    _, step, batch = _train_setup()
    _run_step(step, batch)
    assert seen == [True]
