"""The port's test-set evaluation against the JAX package, on the CPU:
metrics, the volume path, the inference CLI's aggregation, dataset
readers, Lightning checkpoints, the parameter count and the overlays. The
same numpy-seeded inputs go through both; host-side functions must agree
exactly (NaN where both are NaN), model predictions on >= 99.9% of voxels.
"""
import logging
import math
import os

import cv2
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceigm_unet_tpu.cli.inference as jinference
import ceigm_unet_tpu.data.datasets as jdatasets
import ceigm_unet_tpu.eval.metrics as jmetrics
import ceigm_unet_tpu.eval.plot as jplot
from ceigm_unet_tpu.eval.volume import eval_single_volume as jeval_volume
from ceigm_unet_tpu.eval.volume import predict_volume as jpredict_volume
from ceigm_unet_tpu.models import build_model as jbuild_model
from ceigm_unet_tpu_torch.cli import calc_params
from ceigm_unet_tpu_torch.cli import inference
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.convert.checkpoint import (load_model,
                                                     strip_lightning_prefix)
from ceigm_unet_tpu_torch.data import datasets
from ceigm_unet_tpu_torch.entry import synthetic_batch
from ceigm_unet_tpu_torch.eval import metrics, plot
from ceigm_unet_tpu_torch.eval.volume import (eval_single_volume,
                                              predict_volume)
from ceigm_unet_tpu_torch.models import build_model
from ceigm_unet_tpu_torch.train.loop import setup_logger
from plain_volume import plain_predict_volume

torch.set_num_threads(1)

# tests/test_torch_model.py's logits tolerance and gm_test depths
LOGITS_TOL = dict(rtol=1e-3, atol=1e-3)
GM_TEST_DEPTHS = (1, 1, 1, 1)


def _same(got, want):
    """Equal, or NaN on both sides; dicts and lists element by element."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
    else:
        assert type(got) is type(want) and got == want, (got, want)


# --- metrics ------------------------------------------------------------------

def _mask(shape, box):
    m = np.zeros(shape, bool)
    m[box] = True
    return m


_EMPTY5 = np.zeros((5, 5), bool)
_SQUARE5 = _mask((5, 5), np.s_[1:4, 1:4])
_P8 = _mask((8, 8), np.s_[2, 2])
_P6 = _mask((6, 6), np.s_[1, 3])
_NEST_P = _mask((11, 11), np.s_[2:9, 2:9])
_NEST_G = _mask((11, 11), np.s_[3:8, 3:8])
_ID = _mask((9, 9), np.s_[2:7, 3:8])

# the geometry of tests/test_eval_metrics.py: (name, function, pred, gt,
# spacing)
GOLDEN = [
    ("dice", "dice_binary", _mask((4, 4), np.s_[1:3, 1:2]),
     _mask((4, 4), np.s_[1:3, 1:3]), None),
    ("dice_self", "dice_binary", _mask((4, 4), np.s_[1:3, 1:3]),
     _mask((4, 4), np.s_[1:3, 1:3]), None),
    ("dice_quirk_gt_empty", "dice_binary", np.ones((3, 3), bool),
     np.zeros((3, 3), bool), None),
    ("dice_both_empty", "dice_binary", np.zeros((3, 3), bool),
     np.zeros((3, 3), bool), None),
    ("dice_pred_empty", "dice_binary", np.zeros((3, 3), bool),
     np.ones((3, 3), bool), None),
    ("jaccard", "jaccard_binary", _mask((4, 4), np.s_[1:3, 0:2]),
     _mask((4, 4), np.s_[0:2, 0:2]), None),
    ("jaccard_empty", "jaccard_binary", np.zeros((4, 4), bool),
     np.zeros((4, 4), bool), None),
    ("surface_pixel_pair", "surface_metrics", _P8,
     _mask((8, 8), np.s_[2, 5]), None),
    ("surface_pixel_diagonal", "surface_metrics", _P8,
     _mask((8, 8), np.s_[4, 4]), None),
    ("surface_spacing_rows", "surface_metrics", _P6,
     _mask((6, 6), np.s_[2, 3]), (2.5, 1.0)),
    ("surface_spacing_cols", "surface_metrics", _P6, np.roll(_P6, 1, axis=1),
     (2.5, 1.0)),
    ("surface_empty_pred", "surface_metrics", _EMPTY5, _SQUARE5, None),
    ("surface_empty_gt", "surface_metrics", _SQUARE5, _EMPTY5, None),
    ("surface_both_empty", "surface_metrics", _EMPTY5, _EMPTY5, None),
    ("surface_nested", "surface_metrics", _NEST_P, _NEST_G, None),
    ("surface_nested_reverse", "surface_metrics", _NEST_G, _NEST_P, None),
    ("surface_identical", "surface_metrics", _ID, _ID.copy(), None),
]


@pytest.mark.parametrize("name,fn,pred,gt,spacing", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_golden_geometry_matches_jax(name, fn, pred, gt, spacing):
    args = (pred, gt) if spacing is None else (pred, gt, spacing)
    _same(getattr(metrics, fn)(*args), getattr(jmetrics, fn)(*args))


def _random_masks(ndim, seed, empty):
    """Two overlapping blobby masks (thresholded smoothed noise); ``empty``
    empties the prediction, the label or both."""
    from scipy.ndimage import uniform_filter
    rng = np.random.default_rng(seed)
    shape = (24, 28) if ndim == 2 else (6, 20, 18)
    p = uniform_filter(rng.random(shape), 5) > 0.52
    g = uniform_filter(rng.random(shape), 5) > 0.5
    if empty in ("pred", "both"):
        p[...] = False
    if empty in ("gt", "both"):
        g[...] = False
    return p, g


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("spacing", [False, True])
@pytest.mark.parametrize("empty", [None, "pred", "gt", "both"])
def test_random_masks_match_jax(ndim, spacing, empty):
    p, g = _random_masks(ndim, 10 * ndim + 3 * spacing, empty)
    if empty is None:
        assert p.any() and g.any() and (p != g).any()
    sp = (2.5, 0.7, 0.9)[-ndim:] if spacing else None
    for fn in ("dice_binary", "jaccard_binary"):
        _same(getattr(metrics, fn)(p, g), getattr(jmetrics, fn)(p, g))
    _same(metrics.surface_metrics(p, g, sp),
          jmetrics.surface_metrics(p, g, sp))


def test_segmeter_and_class_maps_match_jax():
    assert metrics.CLASS_COLOR_MAPS == jmetrics.CLASS_COLOR_MAPS
    assert metrics.SYNAPSE_CLASS_COLOR_MAP == jmetrics.SYNAPSE_CLASS_COLOR_MAP
    assert metrics.ACDC_CLASS_COLOR_MAP == jmetrics.ACDC_CLASS_COLOR_MAP
    lbl = np.zeros((2, 6, 6), np.int32)             # the golden ACDC case
    lbl[0, 0:2, 0:2] = 1
    lbl[1, 2:4, 2:4] = 2
    pred = lbl.copy()
    pred[0, 0:2, 0] = 0
    rng = np.random.default_rng(4)
    for nc, p, g in [(4, pred, lbl),
                     (9, rng.integers(0, 9, (3, 4, 10, 12)),
                      rng.integers(0, 9, (3, 4, 10, 12)))]:
        got, want = metrics.SegMeter(nc), jmetrics.SegMeter(nc)
        for m in (got, want):
            m(p, g)
            m(g, g)
        _same(got.get_metric(), want.get_metric())
        _same(got.mean_dice(), want.mean_dice())


# --- the volume path and the CLI's aggregation, exact predictor --------------

class ExactPredictor(torch.nn.Module):
    """One-hot logits of round(raw): undoes the (x - 0.5) / 0.5 of
    ``predict_volume``, so a volume whose voxels are class ids comes back
    as its own label map. Its one parameter fixes its device."""

    def __init__(self, num_classes):
        super().__init__()
        self.onehot = torch.nn.Parameter(torch.eye(num_classes) * 10.0,
                                         requires_grad=False)

    def forward(self, x):
        raw = x[..., 0] * 0.5 + 0.5
        n = self.onehot.shape[0]
        return self.onehot[torch.round(raw).clamp(0, n - 1).long()]


def _jexact(num_classes):
    """tests/test_eval_metrics.py's exact ``apply_fn``."""
    def apply_fn(variables, x):
        raw = x[..., 0] * 0.5 + 0.5
        cls = jnp.clip(jnp.round(raw), 0, num_classes - 1).astype(jnp.int32)
        return jnp.eye(num_classes, dtype=jnp.float32)[cls] * 10.0
    return apply_fn


def _volume_with_classes():
    """tests/test_eval_metrics.py's (3, 8, 8) volume of class ids and its
    label, which differs on class 2 (a nested corner)."""
    vol = np.zeros((3, 8, 8), np.float32)
    lbl = np.zeros((3, 8, 8), np.int64)
    vol[0, 1:4, 1:4] = 1.0
    lbl[0, 1:4, 1:4] = 1
    vol[1, 2:6, 2:6] = 2.0
    lbl[1, 3:6, 3:6] = 2
    vol[2, 0:2, 4:8] = 3.0
    lbl[2, 0:2, 4:8] = 3
    return vol, lbl


def _two_cases():
    vol, lbl = _volume_with_classes()
    vol2 = np.zeros((2, 8, 8), np.float32)
    lbl2 = np.zeros((2, 8, 8), np.int64)
    vol2[:, 4:7, 0:3] = 1.0
    lbl2[:, 4:7, 0:3] = 1
    return [{"image": vol, "label": lbl, "case_name": "caseA"},
            {"image": vol2, "label": lbl2, "case_name": "caseB"}]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    logger.handlers[:] = [_Lines()]
    return logger


def test_eval_single_volume_matches_jax():
    vol, lbl = _volume_with_classes()
    got = eval_single_volume(ExactPredictor(4), vol, lbl, num_classes=4,
                             patch_size=(8, 8), batch_size=2)
    want = jeval_volume(_jexact(4), {}, vol, lbl, num_classes=4,
                        patch_size=(8, 8), batch_size=2)
    _same(got, want)
    assert got["dice"]["Myo"][0] == pytest.approx(18 / 25)


def test_test_single_volume_matches_jax():
    vol, lbl = _volume_with_classes()
    got = inference.test_single_volume(ExactPredictor(4), vol, lbl, 4,
                                       (8, 8))
    want = jinference.test_single_volume(_jexact(4), {}, vol, lbl, 4,
                                         (8, 8))
    _same(got, want)
    assert got["RV"] == {"dice": 1.0, "jaccard": 1.0, "hd95": 0.0,
                         "asd": 0.0}


def test_run_inference_matches_jax():
    """Per-case -> per-class (nanmean) -> global (nanmean), and the same
    log lines."""
    got_log, want_log = _logger("port_inf"), _logger("jax_inf")
    got = inference.run_inference(_two_cases(), ExactPredictor(4), 4,
                                  got_log, patch_size=(8, 8))
    want = jinference.run_inference(_two_cases(), {}, 4, want_log,
                                    patch_size=(8, 8), apply_fn=_jexact(4))
    _same(got, want)
    assert got_log.handlers[0].lines == want_log.handlers[0].lines
    assert got_log.handlers[0].lines[-1].startswith("global: dice ")
    assert got[0]["LV"]["dice"] == 0.5


# --- the gm_test model ---------------------------------------------------------

@pytest.fixture(scope="module")
def gm_test():
    """JAX gm_test variables and its jitted forward; the port model loaded
    with the same weights; a seeded (2, 64, 64, 1) input."""
    jm = jbuild_model(enc_name="gm_test", scan_backend="assoc")
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 1)).astype(
        np.float32)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), v)
    model = build_model(enc_name="gm_test", device="cpu")
    jax_import.load_numpy_state_dict(model, jax_import.state_dict_from_jax(
        v, depths=GM_TEST_DEPTHS))
    return dict(jm=jm, v=v, x=x, model=model, apply=jax.jit(jm.apply))


def test_gm_test_inference_matches_jax(gm_test, monkeypatch):
    """``test_single_volume`` on a (3, 80, 80) blob volume at patch 64:
    the port's class map agrees with JAX's on >= 99.9% of voxels, and its
    table equals the JAX metric functions applied to that map."""
    b = synthetic_batch(3, 80, 9, seed=3, device="cpu")
    vol = (b["image"][..., 0].numpy() * 0.5 + 0.5).astype(np.float32)
    lbl = b["label"].numpy()
    maps = []

    def spy(*args, **kw):
        maps.append(predict(*args, **kw))
        return maps[-1]

    predict = inference.predict_volume
    monkeypatch.setattr(inference, "predict_volume", spy)
    got = inference.test_single_volume(gm_test["model"], vol, lbl, 9,
                                       (64, 64))
    pred = maps[0]
    want = jpredict_volume(gm_test["jm"].apply, gm_test["v"], vol, (64, 64))
    assert pred.shape == vol.shape and (pred == want).mean() >= 0.999
    assert len(np.unique(pred)) > 1
    table = {}
    for name, (idx, _) in jmetrics.SYNAPSE_CLASS_COLOR_MAP.items():
        p, g = pred == idx, lbl == idx
        table[name] = {"dice": jmetrics.dice_binary(p, g),
                       "jaccard": jmetrics.jaccard_binary(p, g),
                       **jmetrics.surface_metrics(p, g)}
    _same(got, table)


@pytest.mark.parametrize("depth", [3, 4, 5])
@pytest.mark.parametrize("which", ["gm_test", "exact300"])
def test_predict_volume_matches_the_plain_loop(gm_test, which, depth):
    """At batch 4, depths below, equal to and one over a multiple of it:
    ``predict_volume`` returns as int32 exactly the plain loop's maps, on
    the narrow path (gm_test, 9 classes) and the wide one (300 classes,
    class ids past 255), and a later call of another depth leaves the
    returned array as it was (no view of the staging buffer). The model's
    inputs are the plain loop's, bit for bit."""
    rng = np.random.default_rng(depth)
    if which == "gm_test":
        model, hw, patch = gm_test["model"], (40, 48), (32, 32)
        vol = rng.random((depth, *hw)).astype(np.float32)
    else:
        model, hw, patch = ExactPredictor(300), (10, 12), (8, 8)
        vol = rng.integers(0, 300, (depth, *hw)).astype(np.float32)
    seen = []
    hook = model.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].clone()))
    try:
        got = predict_volume(model, vol, patch, 4)
        want = plain_predict_volume(model, vol, patch, 4)
    finally:
        hook.remove()
    assert got.dtype == np.int32 and got.shape == vol.shape
    assert np.array_equal(got, want)
    # the forward saw the plain loop's inputs bit for bit: full batches,
    # zero-padded
    n = -(-depth // 4)
    assert len(seen) == 2 * n and all(
        torch.equal(a, b) for a, b in zip(seen[:n], seen[n:]))
    assert got.max() > (255 if which == "exact300" else 0)
    kept = got.copy()
    predict_volume(model, vol.max() - np.concatenate([vol, vol[:3]]),
                   patch, 4)
    assert np.array_equal(got, kept)


# --- checkpoints ----------------------------------------------------------------

def _lightning_file(path, sd):
    """A Lightning-format file: the model under ``_model.`` beside pickled
    optimizer state and hyperparameters."""
    torch.save({"state_dict": {"_model." + k: v for k, v in sd.items()},
                "optimizer_states": [{"state": {}, "lr": 5e-4}],
                "hyper_parameters": {"enc_name": "gm_test"}, "epoch": 3},
               path)
    return str(path)


def test_lightning_checkpoint_round_trip(gm_test, tmp_path, monkeypatch):
    sd = gm_test["model"].state_dict()
    path = _lightning_file(tmp_path / "best.ckpt", sd)
    model = load_model(path, 9, enc_name="gm_test", device="cpu")
    got = model.state_dict()
    assert list(got) == list(sd) and not model.training
    for k in sd:
        assert got[k].dtype == sd[k].dtype and torch.equal(got[k], sd[k]), k
    x = torch.from_numpy(gm_test["x"])
    with torch.no_grad():
        logits = model(x)
        assert torch.equal(logits, gm_test["model"](x))
    # the JAX package reads the same file (at gm_test's depths)
    from ceigm_unet_tpu import convert
    full = convert.convert_msvm_unet_state_dict
    monkeypatch.setattr(convert, "convert_msvm_unet_state_dict",
                        lambda s: full(s, depths=GM_TEST_DEPTHS))
    v = jinference.load_variables(path)
    np.testing.assert_allclose(
        np.asarray(gm_test["apply"](v, jnp.asarray(gm_test["x"]))),
        logits.numpy(), **LOGITS_TOL)


def test_checkpoint_mismatch_and_orbax_refused(gm_test, tmp_path):
    sd = dict(gm_test["model"].state_dict())
    gone = "decoder.lgag3.psi.0.weight"
    del sd[gone]
    sd["decoder.extra.weight"] = torch.zeros(2)
    path = _lightning_file(tmp_path / "bad.ckpt", sd)
    with pytest.raises(KeyError) as err:
        load_model(path, 9, enc_name="gm_test", device="cpu")
    assert gone in str(err.value) and "decoder.extra.weight" in str(err.value)
    with pytest.raises(ValueError, match="orbax"):
        load_model(str(tmp_path), 9, enc_name="gm_test", device="cpu")
    # a bare state_dict, with and without the prefix
    bare = strip_lightning_prefix({"_model.a": 1, "b": 2, "x_model.c": 3})
    assert bare == {"a": 1, "b": 2, "x_model.c": 3}


# --- datasets -------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    """Synthetic Synapse (train .npz slices, test_vol .npy.h5 volumes) and
    ACDC (train / valid .npz slices, test .npz volumes) with their lists."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(11)

    def pair(shape, nc):
        return (rng.random(shape).astype(np.float32),
                rng.integers(0, nc, shape).astype(np.float32))

    syn, acdc = root / "synapse", root / "acdc"
    lists = {"syn": root / "lists_Synapse", "acdc": root / "lists_ACDC"}
    for d in [syn, *lists.values()] + [acdc / s for s in
                                       ("train", "valid", "test")]:
        d.mkdir(parents=True)
    train = []
    for i, shape in enumerate([(70, 90), (64, 64), (50, 40)]):
        img, lab = pair(shape, 9)
        train.append(f"case0005_slice{i:03d}")
        np.savez(syn / f"{train[-1]}.npz", image=img, label=lab)
    vols = ["case0008", "case0022"]
    for name, d in zip(vols, (3, 2)):
        img, lab = pair((d, 40, 48), 9)
        with h5py.File(syn / f"{name}.npy.h5", "w") as f:
            f["image"], f["label"] = img, lab
    (lists["syn"] / "train.txt").write_text("\n".join(train) + "\n\n")
    (lists["syn"] / "test_vol.txt").write_text("\n".join(vols) + "\n")
    for split, shapes in [("train", [(60, 52), (64, 64)]),
                          ("valid", [(48, 70)]),
                          ("test", [(3, 40, 36), (2, 30, 44)])]:
        names = []
        for i, shape in enumerate(shapes):
            img, lab = pair(shape, 4)
            names.append(f"case_{i:03d}_{split}.npz")
            np.savez(acdc / split / names[-1], img=img, label=lab)
        (lists["acdc"] / f"{split}.txt").write_text("\n".join(names) + "\n")
    return dict(syn=str(syn), acdc=str(acdc), syn_list=str(lists["syn"]),
                acdc_list=str(lists["acdc"]))


SPLITS = [("Synapse", "train", {}), ("Synapse", "train", {"keep": True}),
          ("Synapse", "train", {"ds": True}), ("Synapse", "test_vol", {}),
          ("ACDC", "train", {}), ("ACDC", "train", {"ds": True}),
          ("ACDC", "valid", {}), ("ACDC", "valid", {"keep": True}),
          ("ACDC", "test", {})]


@pytest.mark.parametrize("which,split,opt", SPLITS)
def test_datasets_match_jax(data_dirs, which, split, opt):
    key = "syn" if which == "Synapse" else "acdc"
    kw = dict(augment=False, img_size=64,
              keep_raw_size=opt.get("keep", False),
              deep_supervision_scales=[(1, 1), (0.5, 0.5), (0.25, 0.25)]
              if opt.get("ds") else None)
    args = (data_dirs[key], split, data_dirs[key + "_list"])
    got = getattr(datasets, which + "Dataset")(*args, **kw)
    want = getattr(jdatasets, which + "Dataset")(*args, **kw)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w) and g["case_name"] == w["case_name"]
        assert g["image"].dtype == np.float32 == w["image"].dtype
        assert g["image"].shape == w["image"].shape
        np.testing.assert_allclose(g["image"], w["image"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(g["label"], w["label"])
        assert g["label"].dtype == w["label"].dtype
        for a, b in zip(g.get("label_pyramid", []),
                        w.get("label_pyramid", [])):
            np.testing.assert_array_equal(a, b)


def test_train_augmentation_is_refused(data_dirs):
    """Train-split augmentation, once refused, is now ported: a train split
    with ``augment`` gives the JAX package's augmented samples
    (tests/test_torch_data.py holds every op and split against JAX)."""
    for which, key in [("Synapse", "syn"), ("ACDC", "acdc")]:
        args = (data_dirs[key], "train", data_dirs[key + "_list"])
        got = getattr(datasets, which + "Dataset")(*args, img_size=64)
        want = getattr(jdatasets, which + "Dataset")(*args, img_size=64)
        for i in range(len(want)):
            g = got.get(i, np.random.default_rng(i))
            w = want.get(i, np.random.default_rng(i))
            assert g["image"].tobytes() == w["image"].tobytes()
            assert g["label"].tobytes() == w["label"].tobytes()
    # augmentation applies to the train split only, as in the JAX package
    test = datasets.ACDCDataset(data_dirs["acdc"], "test",
                                data_dirs["acdc_list"], augment=True)
    assert test[0]["image"].shape == (3, 40, 36)


def test_zoom_host_matches_jax():
    from ceigm_unet_tpu.ops.resize import zoom_host as jzoom_host
    from ceigm_unet_tpu_torch.ops.resize import zoom_host
    img = np.random.default_rng(2).random((45, 38)).astype(np.float32)
    for out, order in [((64, 64), 3), ((20, 17), 3), ((64, 51), 0),
                       ((45, 38), 3), ((30, 30), 1)]:
        got, want = zoom_host(img, out, order), jzoom_host(img, out, order)
        assert got.dtype == np.float32 and got.shape == want.shape
        tol = 0 if order == 0 else 1e-5
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_resolve_list_dir_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    vendored = datasets._resolve_list_dir("./lists/lists_Synapse")
    assert os.path.isabs(vendored) and os.path.isfile(
        os.path.join(vendored, "test_vol.txt"))
    (tmp_path / "mine").mkdir()
    for p in ["./lists/lists_Synapse", "lists/lists_ACDC",
              str(tmp_path / "mine"), "../lists/lists_Synapse",
              "./../lists/lists_ACDC", "./nowhere"]:
        assert datasets._resolve_list_dir(p) == jdatasets._resolve_list_dir(p)
    assert datasets._resolve_list_dir("../lists/lists_Synapse") == \
        "../lists/lists_Synapse"


# --- calc_params, overlays, logger, command line -------------------------------

@pytest.mark.parametrize("num_classes", [9, 4])
def test_param_count_matches_jax(num_classes):
    """Parameters equal JAX's (counted from ``jax.eval_shape`` of init, no
    compile); the FLOPs of a 64x64 forward are finite and positive."""
    n, flops = calc_params.count_params_flops(num_classes, img_size=64)
    jm = jbuild_model(num_classes=num_classes, enc_name="gm_tiny",
                      scan_backend="assoc")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 1),
                                                 jnp.float32))
    assert n == sum(int(np.prod(p.shape))
                    for p in jax.tree_util.tree_leaves(shapes["params"]))
    assert isinstance(flops, int) and 0 < flops < float("inf")


def test_count_params_flops_refuses_the_card():
    """On the card the hand kernels would hide their FLOPs from the
    counter, so the count runs on the CPU only."""
    with pytest.raises(ValueError, match="CPU"):
        calc_params.count_params_flops(4, img_size=64, device="cuda")


@pytest.mark.parametrize("num_classes", [4, 9])
def test_overlay_matches_jax(num_classes, tmp_path):
    b = synthetic_batch(1, 48, num_classes, seed=num_classes, device="cpu")
    img = b["image"][0, ..., 0].numpy()
    mask = b["label"][0].numpy()
    got = plot.overlay(img, mask, num_classes)
    assert got.dtype == np.uint8 and got.shape == (48, 48, 3)
    assert got.tobytes() == jplot.overlay(img, mask, num_classes).tobytes()
    pred = np.roll(mask, 3, axis=1)
    paths = [str(tmp_path / d / f) for d in ("port", "jax")
             for f in ("y.png", "y_hat.png")]
    plot.save_x_y_hat(img, mask, pred, num_classes, *paths[:2])
    jplot.save_x_y_hat(img, mask, pred, num_classes, *paths[2:])
    for a, w in zip(paths[:2], paths[2:]):
        assert open(a, "rb").read() == open(w, "rb").read()
    assert np.array_equal(cv2.imread(paths[1]),
                          plot.overlay(img, pred, num_classes))


def test_setup_logger_writes_its_file(tmp_path):
    logger = setup_logger(str(tmp_path / "logs"), "inference_acdc")
    logger.info("global: dice 1.0000")
    logger = setup_logger(str(tmp_path / "logs"), "inference_acdc")
    assert len(logger.handlers) == 2
    for h in logger.handlers:
        h.flush()
    text = (tmp_path / "logs" / "inference_acdc.log").read_text()
    assert text.count("| INFO | global: dice 1.0000") == 1


def test_main_dispatches_as_jax(monkeypatch):
    calls = []
    for mod in (inference, jinference):
        for name in ("test_synapse", "test_acdc"):
            monkeypatch.setattr(mod, name, lambda *a, name=name, mod=mod:
                                calls.append((mod, name) + a))
    for argv in (["synapse", "--ckpt", "m.ckpt", "--data-dir", "d"],
                 ["acdc", "--ckpt", "m.pth", "--data-dir", "d",
                  "--list-dir", "l", "--log-dir", "g"]):
        inference.main(argv)
        jinference.main(argv)
        got, want = calls[-2], calls[-1]
        assert got[1:-1] == want[1:] and got[-1] == "cuda"
    inference.main(["acdc", "--ckpt", "m", "--data-dir", "d", "--device",
                    "cpu"])
    assert calls[-1][1:] == ("test_acdc", "m", "d", "./lists/lists_ACDC",
                             "./logs", "cpu")


def test_acdc_cli_end_to_end(data_dirs, tmp_path, monkeypatch):
    """``main`` on the ACDC test split: lists, reader, logger and the
    aggregation, with the exact predictor in place of the checkpoint's
    model; the log file ends with the ``global:`` line."""
    loads = []

    def fake_load(ckpt, num_classes, device="cuda"):
        loads.append((ckpt, num_classes, device))
        return ExactPredictor(num_classes)

    monkeypatch.setattr(inference, "load_model", fake_load)
    summary, global_means = inference.main(
        ["acdc", "--ckpt", "x.ckpt", "--data-dir", data_dirs["acdc"],
         "--list-dir", data_dirs["acdc_list"], "--log-dir",
         str(tmp_path), "--device", "cpu"])
    assert loads == [("x.ckpt", 4, "cpu")]
    assert list(summary) == ["RV", "Myo", "LV"]
    assert list(global_means) == ["dice", "hd95", "jaccard", "asd"]
    lines = (tmp_path / "inference_acdc.log").read_text().splitlines()
    assert sum("| case case_" in ln for ln in lines) == 2
    assert "| global: dice " in lines[-1]


def test_cli_scores_without_tf32(data_dirs, tmp_path, monkeypatch):
    """The split is scored in fp32 with TF32 off, whatever PyTorch's
    settings were, and those come back afterwards."""
    seen = []

    def fake_run(dataset, model, num_classes, logger, patch_size=(224, 224)):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))

    monkeypatch.setattr(inference, "load_model",
                        lambda ckpt, n, device="cuda": ExactPredictor(n))
    monkeypatch.setattr(inference, "run_inference", fake_run)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    inference.main(["acdc", "--ckpt", "x.ckpt", "--data-dir",
                    data_dirs["acdc"], "--list-dir", data_dirs["acdc_list"],
                    "--log-dir", str(tmp_path), "--device", "cpu"])
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
