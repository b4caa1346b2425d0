"""The port's training loop, checkpoints, pretrained-encoder load and
training command lines against the JAX package, on the CPU (gm_test at
32x32). The loop's control flow (epochs, the freeze, validation cadence,
``max_steps``, the hard stop, checkpoint names, history rows) is held
against the JAX loop run with a stand-in step and model, so both sides see
the same validation scores; the port trains for real.
"""
import dataclasses
import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ceigm_unet_tpu.cli.inference as jinference
import ceigm_unet_tpu.cli.train_acdc as jtrain_acdc
import ceigm_unet_tpu.cli.train_synapse as jtrain_synapse
import ceigm_unet_tpu.data.datasets as jdatasets
import ceigm_unet_tpu.train.loop as jloop
from ceigm_unet_tpu.convert import torch_import as jtorch_import
from ceigm_unet_tpu.train.config import ACDC_CONFIG as JACDC_CONFIG
from ceigm_unet_tpu.train.trainstep import TrainState
from ceigm_unet_tpu_torch.cli import train_acdc, train_synapse
from ceigm_unet_tpu_torch.convert import checkpoint, torch_import
from ceigm_unet_tpu_torch.data import datasets
from ceigm_unet_tpu_torch.models import build_model
from ceigm_unet_tpu_torch.train import loop
from ceigm_unet_tpu_torch.train.config import ACDC_CONFIG, SYNAPSE_CONFIG
from ceigm_unet_tpu_torch.train.trainstep import cosine_lr

torch.set_num_threads(1)

GM_TEST_DEPTHS = (1, 1, 1, 1)
TINY = dict(enc_name="gm_test", img_size=32, batch_size=2, num_workers=0)


@pytest.fixture(scope="module")
def acdc_dir(tmp_path_factory):
    """ACDC-format train slices (5, so 2 steps per epoch at batch 2) and
    one test volume, with their lists."""
    root = tmp_path_factory.mktemp("acdc")
    data, lists = root / "ACDC", root / "lists"
    for d in (data / "train", data / "test", lists):
        d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    names = []
    for i in range(5):
        names.append(f"case_{i:03d}_sliceED_0.npz")
        np.savez(data / "train" / names[-1],
                 img=rng.random((48, 48)).astype(np.float32),
                 label=rng.integers(0, 4, (48, 48)).astype(np.float32))
    (lists / "train.txt").write_text("\n".join(names))
    np.savez(data / "test" / "case_t.npz",
             img=rng.random((3, 48, 48)).astype(np.float32),
             label=rng.integers(0, 4, (3, 48, 48)).astype(np.float32))
    (lists / "test.txt").write_text("case_t.npz")
    return dict(data=str(data), lists=str(lists))


def _cfg(base, acdc_dir, tmp_path, tag, **kw):
    return dataclasses.replace(
        base, data_dir=acdc_dir["data"], list_dir=acdc_dir["lists"],
        log_dir=str(tmp_path / tag / "logs"),
        ckpt_dir=str(tmp_path / tag / "ckpt"), **{**TINY, **kw})


def _rows(cfg):
    path = os.path.join(cfg.log_dir, f"{cfg.name}.metrics.jsonl")
    with open(path) as f:
        return [json.loads(ln) for ln in f]


# --- the loop against JAX's -------------------------------------------------

class _Dice:
    """Validation scores in a fixed order, whatever the model predicts."""

    def __init__(self):
        self.values = iter([0.2, 0.1, 0.3, 0.3, 0.25, 0.5, 0.4, 0.6])

    def __call__(self, *args, **kw):
        return {"dice": {"c1": [next(self.values)]}}


def _run_jax(cfg, ds, vols, max_steps, monkeypatch):
    """JAX's run_training with a stand-in model and step (its control flow
    only); returns its history rows and the checkpoints it saved."""
    saved = []

    def fake_state(model, rng, sample, tx):
        return TrainState(step=jnp.zeros((), jnp.int32),
                          params={"encoder": {"w": jnp.zeros(1)}},
                          batch_stats={}, opt_state=(), tx=tx)

    def fake_step(model, ce, dc, device_aug_size=None):
        return lambda state, b, rng, freeze: (
            state.replace(step=state.step + 1), {"loss": jnp.float32(1.0)})

    with monkeypatch.context() as mp:
        mp.setattr(jloop, "build_model", lambda **kw: None)
        mp.setattr(jloop, "create_train_state", fake_state)
        mp.setattr(jloop, "make_train_step", fake_step)
        mp.setattr(jloop, "make_optimizer", lambda *a, **k: optax.identity())
        mp.setattr(jloop, "eval_single_volume", _Dice())
        mp.setattr(jloop, "save_checkpoint", lambda d, name, state, extra:
                   saved.append((name, extra)))
        state = jloop.run_training(cfg, ds, vols, max_steps=max_steps)
    return _rows(cfg), saved, int(state.step)


def _run_port(cfg, ds, vols, max_steps, monkeypatch, **kw):
    """The port's run_training; returns its history rows, the checkpoints
    it saved (with the encoder's tensors at each save), the model and the
    step."""
    saved, save = [], checkpoint.save_checkpoint

    def spy(ckpt_dir, name, model, step, epoch, extra=None):
        enc = {k: v.clone() for k, v in model.encoder.state_dict().items()}
        saved.append((name, dict(extra or {}, epoch=epoch), step, enc))
        return save(ckpt_dir, name, model, step, epoch, extra)

    with monkeypatch.context() as mp:
        mp.setattr(loop, "eval_single_volume", _Dice())
        mp.setattr(loop, "save_checkpoint", spy)
        model, step = loop.run_training(cfg, ds, vols, max_steps=max_steps,
                                        device="cpu", **kw)
    return _rows(cfg), saved, model, step


CASES = {"stop_epoch": dict(max_epochs=6, stop_epoch=3),
         "max_steps": dict(max_epochs=6, max_steps=3),
         "late_cadence": dict(max_epochs=4, val_switch_epoch=1,
                              val_every_late=2)}


@pytest.mark.parametrize("case", CASES)
def test_run_training_matches_jax_control_flow(acdc_dir, tmp_path,
                                               monkeypatch, case):
    kw = dict(CASES[case])
    max_steps = kw.pop("max_steps", None)
    common = dict(val_every_early=1, freeze_encoder_epochs=1, **kw)
    jcfg = _cfg(JACDC_CONFIG, acdc_dir, tmp_path, "jax", **common)
    cfg = _cfg(ACDC_CONFIG, acdc_dir, tmp_path, "port", **common)
    vols = [{"image": np.zeros((2, 32, 32), np.float32),
             "label": np.zeros((2, 32, 32), np.float32)}]
    jds = jdatasets.ACDCDataset(jcfg.data_dir, "train", jcfg.list_dir, 32,
                                seed=1)
    ds = datasets.ACDCDataset(cfg.data_dir, "train", cfg.list_dir, 32,
                              seed=1)
    want_rows, want_saved, want_step = _run_jax(jcfg, jds, vols, max_steps,
                                                monkeypatch)
    rows, saved, model, step = _run_port(cfg, ds, vols, max_steps,
                                         monkeypatch)
    assert len(rows) == len(want_rows) > 0
    for r, w in zip(rows, want_rows):
        assert list(r) == list(w)
        for k in ("epoch", "step", "val_mean_dice"):
            assert r.get(k) == w.get(k), (k, r, w)
        # the JAX schedule computes in float32, the port's in float64
        assert r["lr"] == pytest.approx(w["lr"], rel=1e-6)
        assert np.isfinite(r["mean_train_loss"])
    assert [(n, e) for n, e, _, _ in saved] == want_saved
    assert step.count == want_step
    for name in {n for n, *_ in saved}:
        assert os.path.isfile(os.path.join(cfg.ckpt_dir, name + ".ckpt"))
    # the encoder's parameters are frozen in epoch 0 (bitwise; its
    # BatchNorm statistics update, as JAX's batch_stats do) and train after
    fresh = dict(build_model(num_classes=4, enc_name="gm_test",
                             seed=cfg.seed, device="cpu")
                 .encoder.named_parameters())
    last = [s[3] for s in saved if s[0].endswith("-last")]
    assert all(torch.equal(last[0][k], v) for k, v in fresh.items())
    assert not all(torch.equal(last[-1][k], v) for k, v in fresh.items())


@pytest.mark.parametrize("dtype,tf32", [("float32", False),
                                         ("bfloat16", True)])
def test_fp32_training_runs_without_tf32(dtype, tf32, monkeypatch):
    """An fp32 run trains with TF32 off, as the reference's fp32; other
    dtypes leave PyTorch's settings; both come back after the run."""
    seen = []
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(loop, "_run_training", lambda *a: seen.append(
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, a[-1])))
    cfg = dataclasses.replace(SYNAPSE_CONFIG, compute_dtype=dtype)
    loop.run_training(cfg, None, device="cpu")
    assert seen == [(tf32, tf32, torch.device("cpu"))]
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


def test_should_validate_matches_jax():
    from ceigm_unet_tpu.train.config import SYNAPSE_CONFIG as JSYN
    for cfg, jcfg in ((SYNAPSE_CONFIG, JSYN), (ACDC_CONFIG, JACDC_CONFIG)):
        got = [loop.should_validate(e, cfg) for e in range(300)]
        assert got == [jloop.should_validate(e, jcfg) for e in range(300)]
        assert any(got)


def test_metric_history_appends_rows(tmp_path):
    path = tmp_path / "h" / "x.metrics.jsonl"
    h = loop.MetricHistory(str(path))
    h.append(epoch=0, lr=1e-3)
    loop.MetricHistory(str(path)).append(epoch=1)
    assert [json.loads(ln) for ln in path.read_text().splitlines()] == [
        {"epoch": 0, "lr": 1e-3}, {"epoch": 1}]


# --- checkpoints and resume ------------------------------------------------------

def test_save_checkpoint_round_trip(tmp_path, monkeypatch):
    """Read back bitwise by load_model, and by the JAX package's
    load_variables as the variables of the same state_dict."""
    model = build_model(num_classes=9, enc_name="gm_test", seed=4,
                        device="cpu")
    path = checkpoint.save_checkpoint(str(tmp_path), "run-last", model, 17,
                                      5, {"val_mean_dice": 0.5})
    assert path == str(tmp_path / "run-last.ckpt")
    payload = checkpoint.load_checkpoint(path)
    assert (payload["global_step"], payload["epoch"],
            payload["val_mean_dice"]) == (17, 5, 0.5)
    got = checkpoint.load_model(path, 9, enc_name="gm_test", device="cpu")
    want = model.state_dict()
    assert list(got.state_dict()) == list(want)
    for k, v in got.state_dict().items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    full = jtorch_import.convert_msvm_unet_state_dict
    monkeypatch.setattr(jtorch_import, "convert_msvm_unet_state_dict",
                        lambda s: full(s, depths=GM_TEST_DEPTHS))
    import ceigm_unet_tpu.convert as jconvert
    monkeypatch.setattr(jconvert, "convert_msvm_unet_state_dict",
                        lambda s: full(s, depths=GM_TEST_DEPTHS))
    v = jinference.load_variables(path)
    w = full(want, depths=GM_TEST_DEPTHS)
    assert jax.tree_util.tree_structure(v) == \
        jax.tree_util.tree_structure(w)
    for a, b in zip(jax.tree_util.tree_leaves(v), jax.tree_util.tree_leaves(w)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_restores_what_jax_restores(acdc_dir, tmp_path, monkeypatch):
    """Parameters, BatchNorm buffers, the optimizer's step count (the LR
    schedule's) and the epoch after the saved one; the loop's own step
    count restarts at 0, as in JAX."""
    cfg = _cfg(ACDC_CONFIG, acdc_dir, tmp_path, "a", max_epochs=4,
               stop_epoch=2, freeze_encoder_epochs=0)
    ds = datasets.ACDCDataset(cfg.data_dir, "train", cfg.list_dir, 32,
                              seed=1)
    model, step = loop.run_training(cfg, ds, device="cpu")
    last = os.path.join(cfg.ckpt_dir, "acdc-last.ckpt")
    assert step.count == 4 and checkpoint.load_checkpoint(last)["epoch"] == 1

    # resumed at the hard stop: nothing trains, the state is the file's
    cfg_b = dataclasses.replace(cfg, log_dir=str(tmp_path / "b"),
                                ckpt_dir=str(tmp_path / "b"))
    resumed, rstep = loop.run_training(cfg_b, ds, resume_from=last,
                                       device="cpu")
    assert rstep.count == 4
    want = model.state_dict()
    assert any("running_mean" in k for k in want)
    for k, v in resumed.state_dict().items():
        assert torch.equal(v, want[k]), k

    # one more epoch: epoch 2 at the LR of optimizer steps 4 and 5
    opts = []
    make = loop.make_optimizer
    monkeypatch.setattr(loop, "make_optimizer",
                        lambda *a: opts.append(make(*a)) or opts[-1])
    cfg_c = dataclasses.replace(cfg, stop_epoch=3,
                                log_dir=str(tmp_path / "c"),
                                ckpt_dir=str(tmp_path / "c"))
    _, cstep = loop.run_training(cfg_c, ds, resume_from=last, device="cpu")
    sched = cosine_lr(cfg.lr, cfg.eta_min, cfg.max_epochs, 2)
    assert cstep.count == 6
    assert opts[0].param_groups[0]["lr"] == sched(5) == sched(4) != sched(3)
    (row,) = _rows(cfg_c)
    assert (row["epoch"], row["step"], row["lr"]) == (2, 2, sched(2))
    # the moments restart at zero: the resumed optimizer counted 2 steps
    moments = [opts[0].state[p] for g in opts[0].param_groups
               for p in g["params"]]
    assert all(int(m["step"]) == 2 for m in moments)


# --- the pretrained encoder --------------------------------------------------------

def _upstream(model, seed=3):
    """A classification checkpoint's state_dict for the encoder's weights
    (new values), with the classifier's head and final norm."""
    gen = torch.Generator().manual_seed(seed)
    sd = {k: (torch.randn(v.shape, generator=gen) if v.is_floating_point()
              else v.clone())
          for k, v in model.encoder.gm_encoder.state_dict().items()}
    sd.update({"norm.weight": torch.ones(8), "norm.bias": torch.zeros(8),
               "head.weight": torch.zeros(10, 8), "head.bias": torch.zeros(10),
               "dist_head.weight": torch.zeros(10, 8),
               "dist_head.bias": torch.zeros(10)})
    return sd


def test_remap_pretrained_keys_matches_jax():
    sd = _upstream(build_model(enc_name="gm_test", device="cpu"))
    sd.update({"layers.2.downsample.reduction.weight": torch.zeros(1),
               "layers.0.blocks.1.ln_1.weight": torch.zeros(1),
               "layers.1.blocks.0.self_attention.x_proj_weight":
                   torch.zeros(1)})
    got = torch_import.remap_pretrained_groupmamba_keys(sd)
    want = jtorch_import.remap_pretrained_groupmamba_keys(sd)
    assert list(got) == list(want)
    assert all(got[k] is want[k] for k in want)
    assert "downsamples.2.reduction.weight" in got and "head.weight" not in got


def test_load_pretrained_encoder_changes_only_the_encoder(tmp_path):
    model = build_model(enc_name="gm_test", device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = _upstream(model)
    path = tmp_path / "groupmamba_tiny.pth"
    torch.save({"model": 1, "state_dict": sd}, path)
    loop.load_pretrained_encoder(model, str(path),
                                 loop.setup_logger(str(tmp_path), "pre"))
    for k, v in model.state_dict().items():
        if k.startswith("encoder.gm_encoder."):
            assert torch.equal(v, sd[k[len("encoder.gm_encoder."):]]), k
        else:
            assert torch.equal(v, before[k]), k
    # a key the encoder lacks is not loaded, as the JAX package's converter
    # reads only the keys it maps; the encoder takes every other tensor
    sd = _upstream(model, seed=4)
    sd["blockX.weight"] = torch.zeros(1)
    torch.save(sd, path)
    loop.load_pretrained_encoder(model, str(path),
                                 loop.setup_logger(str(tmp_path), "pre"))
    enc = model.encoder.gm_encoder.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in enc.items())
    # a key the encoder needs is missing: raises, naming it
    del sd["block2.0.norm2.weight"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match=r"block2\.0\.norm2\.weight"):
        loop.load_pretrained_encoder(model, str(path),
                                     loop.setup_logger(str(tmp_path), "pre"))


def test_load_pretrained_encoder_matches_jax_converter(tmp_path):
    """A checkpoint with keys the encoder lacks (and no BatchNorm
    ``num_batches_tracked``, which JAX never reads) gives the port's encoder
    the weights JAX's ``convert_groupmamba_state_dict`` reads from it; a
    tensor of another shape still raises."""
    model = build_model(enc_name="gm_test", device="cpu")
    sd = {k: v for k, v in _upstream(model).items()
          if not k.endswith("num_batches_tracked")}
    sd.update({"layers.3.downsample.extra.weight": torch.ones(3),
               "blockX.weight": torch.zeros(1)})
    path = tmp_path / "groupmamba_tiny.pth"
    torch.save({"state_dict": sd}, path)
    loop.load_pretrained_encoder(model, str(path),
                                 loop.setup_logger(str(tmp_path), "pre"))
    want = jtorch_import.convert_groupmamba_state_dict(
        jtorch_import.remap_pretrained_groupmamba_keys(sd),
        depths=GM_TEST_DEPTHS)
    got = jtorch_import.convert_groupmamba_state_dict(
        model.encoder.gm_encoder.state_dict(), depths=GM_TEST_DEPTHS)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert [p for p, _ in flat(got)] == [p for p, _ in flat(want)]
    for (path_, a), (_, b) in zip(flat(got), flat(want)):
        np.testing.assert_array_equal(a, b, err_msg=str(path_))
    sd["norm1.weight"] = torch.zeros(3)
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="norm1.weight"):
        loop.load_pretrained_encoder(model, str(path),
                                     loop.setup_logger(str(tmp_path), "pre"))


# --- the command lines --------------------------------------------------------------

ARGV = ["--batch-size", "4", "--max-epochs", "7", "--seed", "3",
        "--compute-dtype", "bfloat16", "--device-aug", "--max-steps", "5",
        "--log-dir", "L", "--ckpt-dir", "C", "--list-dir", "Li",
        "--pretrained-encoder", "P"]


@pytest.mark.parametrize("which", ["synapse", "acdc"])
def test_cli_flags_match_jax(which, monkeypatch):
    """The same argv gives the JAX CLI's configuration, max_steps and
    datasets; ``--device`` defaults to cuda."""
    jmod = jtrain_synapse if which == "synapse" else jtrain_acdc
    mod = train_synapse if which == "synapse" else train_acdc
    calls = {}

    def record(tag):
        def run(cfg, train_ds, val, max_steps=None, **kw):
            calls[tag] = (cfg, max_steps, kw.get("device"), train_ds)
        return run

    class FakeDS:
        def __init__(self, *args, **kw):
            self.args, self.kw = args, kw

    argv = ["--data-dir", "D"] + ARGV
    for m, tag in ((jmod, "jax"), (mod, "port")):
        name = "SynapseDataset" if which == "synapse" else "ACDCDataset"
        monkeypatch.setattr(m, "run_training", record(tag))
        monkeypatch.setattr(m, name, FakeDS)
        monkeypatch.setattr(m, "load_val_volumes", lambda *a: [])
        m.main(argv)
    (jcfg, jsteps, _, jds), (cfg, steps, device, ds) = calls["jax"], \
        calls["port"]
    assert steps == jsteps == 5 and device == "cuda"
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert ds.args == jds.args and ds.kw == jds.kw
    mod.main(argv + ["--device", "cpu"])
    assert calls["port"][2] == "cpu"


def test_train_acdc_main_end_to_end(acdc_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(train_acdc, "ACDC_CONFIG",
                        dataclasses.replace(ACDC_CONFIG, **TINY))
    model, step = train_acdc.main(
        ["--data-dir", acdc_dir["data"], "--list-dir", acdc_dir["lists"],
         "--log-dir", str(tmp_path / "logs"), "--ckpt-dir",
         str(tmp_path / "ckpt"), "--max-steps", "2", "--device", "cpu"])
    assert step.count == 2
    assert (tmp_path / "ckpt" / "acdc-last.ckpt").is_file()
    (row,) = [json.loads(ln) for ln in
              (tmp_path / "logs" / "acdc.metrics.jsonl").read_text()
              .splitlines()]
    assert row["step"] == 2 and row["lr"] > 0 and \
        np.isfinite(row["mean_train_loss"])


def test_train_synapse_main_end_to_end(tmp_path, monkeypatch):
    """Synapse layout: train_npz slices and a test_vol_h5 volume (h5py);
    validation every epoch, so ``-best`` is written."""
    data, lists = tmp_path / "Synapse", tmp_path / "lists"
    for d in (data / "train_npz", data / "test_vol_h5", lists):
        d.mkdir(parents=True)
    rng = np.random.default_rng(1)
    names = [f"case0005_slice{i:03d}" for i in range(4)]
    for n in names:
        np.savez(data / "train_npz" / f"{n}.npz",
                 image=rng.random((40, 40)).astype(np.float32),
                 label=rng.integers(0, 9, (40, 40)).astype(np.float32))
    with h5py.File(data / "test_vol_h5" / "case0008.npy.h5", "w") as f:
        f["image"] = rng.random((2, 40, 40)).astype(np.float32)
        f["label"] = rng.integers(0, 9, (2, 40, 40)).astype(np.float32)
    (lists / "train.txt").write_text("\n".join(names))
    (lists / "test_vol.txt").write_text("case0008\n")
    monkeypatch.setattr(train_synapse, "SYNAPSE_CONFIG", dataclasses.replace(
        SYNAPSE_CONFIG, val_every_early=1, **TINY))
    model, step = train_synapse.main(
        ["--data-dir", str(data), "--list-dir", str(lists), "--log-dir",
         str(tmp_path / "logs"), "--ckpt-dir", str(tmp_path / "ckpt"),
         "--max-steps", "2", "--device", "cpu"])
    assert step.count == 2
    for n in ("synapse-best", "synapse-last"):
        assert (tmp_path / "ckpt" / f"{n}.ckpt").is_file()
    (row,) = [json.loads(ln) for ln in
              (tmp_path / "logs" / "synapse.metrics.jsonl").read_text()
              .splitlines()]
    assert 0.0 <= row["val_mean_dice"] <= 1.0
