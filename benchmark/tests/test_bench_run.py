"""A run end to end on the CPU at the gm_test widths: it loads neither JAX
nor the JAX package, it refuses to run without a card, and with the timed
path broken underneath (each fault a cell can have) its check comes out
not correct, while the unbroken run comes out correct."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import (ROOT, TINY_CONFIG, TINY_TRAIN,
                                      TINY_VOLUMES)

SERVE, TRAIN, TRAIN_BF16 = ("gm_tiny.volumes_bf16_b128",
                             "gm_tiny.train_fp32_b48",
                             "gm_base.train_bf16_b48")


def _run(cell_name, mix, trace=False):
    cell = harness.workload(cell_name)
    return harness.run_cell(cell, TINY_CONFIG, mix, 2 ** 31 + 99, 0.5, trace,
                            torch.device("cpu"), harness.spec(), 0.0,
                            log=lambda *a, **k: None)[0]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        SERVE, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode == 2 and p.stdout == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {ROOT + '/benchmark/tests'!r})\n"
        "from conftest import TINY_CONFIG, TINY_VOLUMES\n"
        "from benchmark import harness\n"
        "cell = harness.workload('gm_tiny.volumes_bf16_b128')\n"
        "harness.run_cell(cell, TINY_CONFIG, TINY_VOLUMES, 5, 0.2, True,\n"
        "                 torch.device('cpu'), harness.spec(), 0.0)\n"
        "print(json.dumps([harness.forbidden_modules(),\n"
        "                  sorted({m.split('.')[0] for m in sys.modules})]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    bad, loaded = json.loads(out.strip().splitlines()[-1])
    assert bad == []
    assert "ceigm_unet_tpu_torch" in loaded
    assert not set(loaded) & {"jax", "jaxlib", "flax", "ceigm_unet_tpu"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ceigm_unet_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert "ceigm_unet_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ceigm_unet_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"ceigm_unet_tpu", "jax"} <= set(harness.forbidden_modules())


def _serve_half(monkeypatch):
    from ceigm_unet_tpu_torch.eval import volume
    whole = volume._predict_batch

    def half(model, slices, patch, out_hw):
        top = whole(model, slices[:slices.shape[0] // 2], patch, out_hw)
        return torch.cat([top, torch.zeros_like(top)])
    monkeypatch.setattr(volume, "_predict_batch", half)


def _serve_altered(monkeypatch):
    from ceigm_unet_tpu_torch.eval import volume
    nearest = volume.zoom_slices_nearest

    def altered(x, hw):
        y = nearest(x, hw).clone()
        y[0, 0, 0] = (y[0, 0, 0] + 1) % 9
        return y
    monkeypatch.setattr(volume, "zoom_slices_nearest", altered)


def _train_unchanged(monkeypatch):
    from torch.optim import optimizer
    saved = []

    def before(opt, args, kwargs):
        saved[:] = [p.detach().clone() for g in opt.param_groups
                    for p in g["params"]]

    def after(opt, args, kwargs):
        with torch.no_grad():
            for p, s in zip((p for g in opt.param_groups
                             for p in g["params"]), saved):
                p.copy_(s)
    handles = [optimizer.register_optimizer_step_pre_hook(before),
               optimizer.register_optimizer_step_post_hook(after)]
    monkeypatch.setattr(sys.modules[__name__], "_handles", handles,
                        raising=False)


def _train_half(monkeypatch):
    """The step's loss on the first half of its batch, after a forward
    over all of it."""
    from benchmark import control
    from ceigm_unet_tpu_torch.train import trainstep
    monkeypatch.setattr(trainstep, "dice_ce_loss", control._half_loss)


@pytest.mark.parametrize("cell,fault", [
    (SERVE, None), (SERVE, _serve_half), (SERVE, _serve_altered)] + [
    (c, f) for c in (TRAIN, TRAIN_BF16)
    for f in (None, _train_unchanged, _train_half)],
    ids=["serve", "serve-half-batch", "serve-altered-answer"] + [
        f"{c}-{f}" for c in ("train-fp32", "train-bf16")
        for f in ("sound", "state-unchanged", "half-batch")])
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    if fault is not None:
        fault(monkeypatch)
    mix = TINY_VOLUMES if cell == SERVE else TINY_TRAIN
    try:
        result = _run(cell, mix)
    finally:
        for h in getattr(sys.modules[__name__], "_handles", []):
            h.remove()
    assert result["correct"] is (fault is None), result["checks"]
