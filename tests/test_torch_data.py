"""The port's training data path against the JAX package, on the CPU: the
native warp library, the host augmentation policy, the train splits with
augmentation, the loader, the on-device augmentation with its parameters
injected, and the train step that augments on the device. The same
numpy-seeded inputs go through both; the host path must give the same
bytes.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import ceigm_unet_tpu.data.augment as jaugment
import ceigm_unet_tpu.data.datasets as jdatasets
import ceigm_unet_tpu.data.device_aug as jdevice_aug
import ceigm_unet_tpu.data.loader as jloader
from ceigm_unet_tpu import native as jnative
from ceigm_unet_tpu_torch import native
from ceigm_unet_tpu_torch.data import augment, datasets, device_aug, loader
from ceigm_unet_tpu_torch.models import build_model
from ceigm_unet_tpu_torch.ops.resize import zoom_host, zoom_slices
from ceigm_unet_tpu_torch.train.trainstep import (make_optimizer,
                                                  make_train_step,
                                                  param_groups)

torch.set_num_threads(1)

# device_augment vs JAX with injected parameters: rtol 1e-5, and atol 5e-5
# of the largest JAX value for the gathers. The float32 coordinate maps
# differ in their last bits (the port sums its products elementwise in a
# fixed order, so that the card and the CPU agree; XLA fuses them), and a
# random image moves by ~1 per pixel, so a gathered value moves by ~1e-5 of
# the largest; a label can flip only where a coordinate sits on a rounding
# boundary (rare: the cases below hold every label exactly).
AUG_TOL = 1e-5
GATHER_ATOL = 5e-5


@pytest.fixture
def jax_scipy_path(monkeypatch):
    """The JAX package on its scipy/numpy path (as with its native build
    unavailable): the reference the native warps are held to."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    assert not jnative.available()


def _assert_close_to_scipy(got, want):
    """A sample of the port's native policy against the JAX package's scipy
    path, at tests/test_native_aug.py's tolerances (image atol 1e-4 on the
    slice's scale, which the contrast op's pivot of 127 can take to ~1e2;
    at most 1e-4 of the labels differ)."""
    (gi, gl), (wi, wl) = got, want
    np.testing.assert_allclose(gi, wi, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(wi).max()))
    assert np.mean(gl != wl) <= 1e-4


# --- the native library ---------------------------------------------------------

def _code(path):
    """A C++ source without its comments and blank lines."""
    text = re.sub(r"//[^\n]*", "", open(path).read())
    return [ln.rstrip() for ln in text.splitlines() if ln.strip()]


def test_native_builds_from_its_own_copy():
    lib = native.build()
    assert lib.parent == native.BUILD_DIR and lib.exists()
    assert native.SRC.parent.name == "native" and \
        "ceigm_unet_tpu_torch" in native.SRC.parts
    jso = jnative._SO
    assert str(lib) != jso and "ceigm_unet_tpu_torch" in lib.parts
    # the same warps as the JAX package's source
    assert _code(native.SRC) == _code(jnative._SRC)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "augwarp.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*"))


def _rand_affine(rng):
    return augment._affine_matrix(
        scale=(rng.uniform(0.5, 2.0), rng.uniform(0.5, 2.0)),
        rotate_deg=rng.uniform(-40, 40), shear_deg=rng.uniform(-16, 16),
        translate=(rng.uniform(-40, 40), rng.uniform(-40, 40)),
        center=(101.5, 77.0))


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_affine_warp_matches_jax_and_scipy(order, seed):
    rng = np.random.default_rng(seed)
    img = rng.random((155, 204)).astype(np.float32)
    inv = np.linalg.inv(_rand_affine(rng))
    m = np.array([[inv[1, 1], inv[1, 0]], [inv[0, 1], inv[0, 0]]])
    off = np.array([inv[1, 2], inv[0, 2]])
    got = native.affine_warp(img, m, off, order)
    assert got.tobytes() == jnative.affine_warp(img, m, off, order).tobytes()
    want = ndimage.affine_transform(img, m, offset=off, order=order,
                                    mode="constant", cval=0.0,
                                    output=np.float32)
    # tests/test_native_aug.py's tolerances
    if order == 1:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert np.mean(got != want) <= 1e-4


def test_native_piecewise_warp_matches_jax_and_numpy(monkeypatch):
    rng = np.random.default_rng(3)
    h, w = 131, 117
    img = rng.random((h, w)).astype(np.float32)
    lab = rng.integers(0, 9, (h, w)).astype(np.float32)
    xg, yg = np.meshgrid(np.linspace(0, w, 4), np.linspace(0, h, 4))
    src = np.stack([yg.ravel(), xg.ravel()], axis=1)
    dst = src + rng.normal(0, 0.02, (16, 2)) * np.array([h, w])
    wi, wl = augment.piecewise_affine_warp(img, lab, src, dst)
    ji, jl = jaugment.piecewise_affine_warp(img, lab, src, dst)
    assert wi.tobytes() == ji.tobytes() and wl.tobytes() == jl.tobytes()
    # the JAX package's numpy path: per-triangle affines and scipy's
    # map_coordinates
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    pi, pl = jaugment.piecewise_affine_warp(img, lab, src, dst)
    np.testing.assert_allclose(wi, pi, rtol=0, atol=1e-4)
    assert np.mean(wl != pl) <= 1e-4
    # more triangles than the native warp holds
    g = np.stack(np.meshgrid(np.linspace(0, h, 13), np.linspace(0, w, 13),
                             indexing="ij"), axis=-1).reshape(-1, 2)
    with pytest.raises(ValueError, match="at most 256"):
        augment.piecewise_affine_warp(img, lab, g, g)


@pytest.mark.parametrize("shape,out", [((512, 512), (224, 224)),
                                       ((317, 428), (224, 224)),
                                       ((45, 38), (64, 64))])
def test_native_sep_resize_matches_jax_and_scipy(shape, out):
    from ceigm_unet_tpu.ops.resize import zoom_host as jzoom_host
    img = np.random.default_rng(shape[0]).random(shape).astype(np.float32)
    got = zoom_host(img, out, order=3)
    assert got.tobytes() == jzoom_host(img, out, order=3).tobytes()
    want = ndimage.zoom(img, (out[0] / shape[0], out[1] / shape[1]),
                        order=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)
    # the matrix-product zoom, zoom_host's path where the band does not fit
    mm = zoom_slices(torch.from_numpy(img), out, 3).numpy()
    np.testing.assert_allclose(mm, want, rtol=0, atol=5e-6)


# --- the host augmentation policy ------------------------------------------------

def _slice(seed, shape=(70, 90), classes=9):
    rng = np.random.default_rng(seed)
    return (rng.random(shape).astype(np.float32),
            rng.integers(0, classes, shape).astype(np.float32))


def _fired(seed):
    rng = np.random.default_rng(seed)
    return set(rng.choice(10, size=rng.integers(0, 5), replace=False))


@pytest.mark.parametrize("jax_path", ["native", "scipy"])
def test_augment_seg_matches_jax(jax_path, request):
    """40 seeds that between them fire every op: the same bytes as the JAX
    package on its native warps, and within test_native_aug.py's
    tolerances of it on scipy's."""
    if jax_path == "scipy":
        request.getfixturevalue("jax_scipy_path")
    fired = set()
    for seed in range(40):
        img, lab = _slice(100 + seed)
        got = augment.augment_seg(np.random.default_rng(seed), img, lab)
        want = jaugment.augment_seg(np.random.default_rng(seed), img, lab)
        assert all(g.dtype == np.float32 for g in got)
        if jax_path == "scipy":
            _assert_close_to_scipy(got, want)
            continue
        for g, w in zip(got, want):
            assert g.tobytes() == w.tobytes(), seed
        fired |= _fired(seed)
    assert jax_path == "scipy" or fired == set(range(10))


@pytest.mark.parametrize("op", [o.name for o in augment.AUG_OPS])
def test_each_aug_op_matches_jax(op, monkeypatch):
    i = [o.name for o in augment.AUG_OPS].index(op)
    assert jaugment.AUG_OPS[i].name == op
    img, lab = _slice(7, (61, 83))
    for jax_native in (True, False):
        with monkeypatch.context() as mp:
            if not jax_native:
                mp.setattr(jnative, "_lib", None)
                mp.setattr(jnative, "_tried", True)
            for seed in (0, 1):
                got = augment.AUG_OPS[i].fn(np.random.default_rng(seed),
                                            img, lab)
                want = jaugment.AUG_OPS[i].fn(np.random.default_rng(seed),
                                              img, lab)
                if not jax_native:
                    _assert_close_to_scipy(got, want)
                    continue
                for g, w in zip(got, want):
                    assert np.asarray(g).tobytes() == \
                        np.asarray(w).tobytes(), seed


# --- train splits with augmentation --------------------------------------------

@pytest.fixture(scope="module")
def train_dirs(tmp_path_factory):
    """Synapse train .npz slices and ACDC train .npz slices of mixed
    shapes, with their lists."""
    root = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(21)
    syn, acdc = root / "synapse", root / "acdc"
    lists = {"syn": root / "lists_Synapse", "acdc": root / "lists_ACDC"}
    for d in [syn, acdc / "train", *lists.values()]:
        d.mkdir(parents=True)
    names = {"syn": [], "acdc": []}
    shapes = [(96, 96), (80, 72), (96, 96), (64, 90), (96, 96), (72, 72),
              (96, 96)]
    for i, shape in enumerate(shapes):
        img = rng.random(shape).astype(np.float32)
        lab = rng.integers(0, 9, shape).astype(np.float32)
        names["syn"].append(f"case0005_slice{i:03d}")
        np.savez(syn / f"{names['syn'][-1]}.npz", image=img, label=lab)
        names["acdc"].append(f"patient{i:03d}_frame01_slice_0.npz")
        np.savez(acdc / "train" / names["acdc"][-1], img=img,
                 label=np.minimum(lab, 3))
    (lists["syn"] / "train.txt").write_text("\n".join(names["syn"]) + "\n")
    (lists["acdc"] / "train.txt").write_text("\n".join(names["acdc"]))
    return dict(syn=str(syn), acdc=str(acdc), syn_list=str(lists["syn"]),
                acdc_list=str(lists["acdc"]), shapes=shapes)


@pytest.mark.parametrize("which", ["Synapse", "ACDC"])
@pytest.mark.parametrize("keep", [False, True])
def test_augmented_train_split_matches_jax(train_dirs, which, keep):
    key = "syn" if which == "Synapse" else "acdc"
    args = (train_dirs[key], "train", train_dirs[key + "_list"])
    kw = dict(img_size=64, seed=3, keep_raw_size=keep)
    got = getattr(datasets, which + "Dataset")(*args, **kw)
    want = getattr(jdatasets, which + "Dataset")(*args, **kw)
    assert got.augment and want.augment and len(got) == len(want)
    for i in range(len(want)):
        g = got.get(i, np.random.default_rng([i, 1]))
        w = want.get(i, np.random.default_rng([i, 1]))
        assert g["case_name"] == w["case_name"]
        for k in ("image", "label"):
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == \
                w[k].tobytes(), (i, k)
    # without an rng, each side draws from the generator of its seed
    for a, b in zip(got[0].values(), want[0].values()):
        assert np.array_equal(a, b)


def test_augmented_train_split_scipy_path(train_dirs, jax_scipy_path):
    """Against the JAX package on its scipy warps and its matrix-product
    zoom: within test_native_aug.py's tolerances."""
    args = (train_dirs["syn"], "train", train_dirs["syn_list"])
    for keep in (True, False):
        got = datasets.SynapseDataset(*args, img_size=64, seed=3,
                                      keep_raw_size=keep)
        want = jdatasets.SynapseDataset(*args, img_size=64, seed=3,
                                        keep_raw_size=keep)
        for i in range(3):
            g = got.get(i, np.random.default_rng(i))
            w = want.get(i, np.random.default_rng(i))
            _assert_close_to_scipy((g["image"], g["label"]),
                                   (w["image"], w["label"]))


# --- the loader -----------------------------------------------------------------

@pytest.mark.parametrize("workers,drop_last,normalize",
                         [(0, True, True), (0, False, False),
                          (2, True, False)])
def test_loader_matches_jax(train_dirs, workers, drop_last, normalize):
    args = (train_dirs["syn"], "train", train_dirs["syn_list"])
    ds = datasets.SynapseDataset(*args, img_size=48, seed=5)
    jds = jdatasets.SynapseDataset(*args, img_size=48, seed=5)
    kw = dict(batch_size=3, seed=11, drop_last=drop_last,
              normalize=normalize)
    got = loader.DataLoader(ds, num_workers=workers, pin_memory=False, **kw)
    want = jloader.DataLoader(jds, num_workers=0, **kw)
    assert len(got) == len(want) == (2 if drop_last else 3)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        gb, wb = list(got), list(want)
        assert len(gb) == len(wb) == len(want)
        for g, w in zip(gb, wb):
            assert g["case_name"] == w["case_name"]
            assert g["image"].dtype == torch.float32
            assert g["image"].numpy().tobytes() == w["image"].tobytes()
            assert g["label"].dtype == torch.int32
            assert g["label"].numpy().tobytes() == w["label"].tobytes()
    assert gb[0]["image"].shape == (3, 48, 48, 1)


def test_loader_refuses_mixed_shapes(train_dirs):
    """Raw slices of different shapes in one batch (ACDC with on-device
    augmentation) raise a ValueError naming the cases and shapes."""
    ds = datasets.ACDCDataset(train_dirs["acdc"], "train",
                              train_dirs["acdc_list"], seed=5,
                              augment=False, keep_raw_size=True)
    dl = loader.DataLoader(ds, batch_size=7, num_workers=0, shuffle=False,
                           normalize=False, pin_memory=False)
    with pytest.raises(ValueError, match="different shapes") as err:
        next(iter(dl))
    for name, shape in zip(ds.samples, train_dirs["shapes"]):
        assert f"{name} {shape}" in str(err.value)


# --- on-device augmentation with injected parameters --------------------------------

def _jax_params(key, B, H, W, out):
    """The draws JAX's device_augment makes from ``key`` (its own key
    splits), as the port's parameter dict."""
    rows = []
    for k in jax.random.split(key, B):
        ka, kp, kw, _, _, kc, ke = jax.random.split(k, 7)
        active = jdevice_aug.someof_active(ka)
        fu, fl, sc, rot, sh, tr = jdevice_aug._affine_params(kp, active)
        ks, kj = jax.random.split(kw)
        pscale = jax.random.uniform(ks, (), minval=0.008, maxval=0.03)
        jit = jax.random.normal(kj, (16, 2)) * pscale * jnp.array(
            [H, W], jnp.float32)
        rows.append(dict(
            active=active, flipud=fu, fliplr=fl, scale=sc, rot=rot,
            shear=sh, trans=tr, jitter=jnp.where(active[8], jit, 0.0),
            alpha=jax.random.uniform(kc, (), minval=0.5, maxval=1.5),
            noise=jax.random.normal(ke, (out, out))))
    return {k: torch.from_numpy(np.stack([np.asarray(r[k]) for r in rows]))
            for k in rows[0]}


def _close(got, want, atol=AUG_TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=AUG_TOL,
                               atol=atol * np.abs(want).max())


@pytest.mark.parametrize("H,W,out,key", [(96, 80, 64, 3), (64, 64, 64, 4),
                                         (120, 96, 48, 5)])
def test_apply_params_matches_jax(H, W, out, key):
    B = 8
    rng = np.random.default_rng(key)
    imgs = rng.random((B, H, W)).astype(np.float32)
    labs = rng.integers(0, 9, (B, H, W)).astype(np.int32)
    jkey = jax.random.PRNGKey(key)
    ji, jl = jdevice_aug.device_augment(jkey, jnp.asarray(imgs),
                                        jnp.asarray(labs), out_size=out)
    p = _jax_params(jkey, B, H, W, out)
    gi, gl = device_aug.apply_params(p, torch.from_numpy(imgs),
                                     torch.from_numpy(labs), out)
    assert gi.dtype == torch.float32 and gl.dtype == torch.int32
    _close(gi, ji, GATHER_ATOL)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(jl))
    assert p["active"].any(0).sum() >= 8   # most ops fire in the batch


def test_compose_matrix_and_piecewise_map_match_jax():
    H, W, out, B = 90, 70, 48, 8
    p = _jax_params(jax.random.PRNGKey(2), B, H, W, out)
    lin, off = device_aug._compose_matrix(p["flipud"], p["fliplr"],
                                          p["scale"], p["rot"], p["shear"],
                                          p["trans"], H, W)
    ys = (np.arange(out) + 0.5) * (H / out) - 0.5
    xs = (np.arange(out) + 0.5) * (W / out) - 0.5
    gy, gx = np.meshgrid(ys.astype(np.float32), xs.astype(np.float32),
                         indexing="ij")
    qy, qx = device_aug._piecewise_map(p["jitter"], torch.from_numpy(gy),
                                       torch.from_numpy(gx), H, W)
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    for b in range(B):
        args = [jnp.asarray(p[k][b].numpy()) for k in
                ("flipud", "fliplr", "scale", "rot", "shear", "trans")]
        jlin, joff = jdevice_aug._compose_matrix(*args, H, W)
        _close(lin[b], jlin)
        _close(off[b], joff)
        kw = jax.random.split(keys[b], 7)[2]
        jqy, jqx = jdevice_aug._piecewise_map(
            kw, jnp.asarray(p["active"][b, 8].item()), jnp.asarray(gy),
            jnp.asarray(gx), H, W)
        _close(qy[b], jqy)
        _close(qx[b], jqx)
    assert p["active"][:, 8].any() and not p["active"][:, 8].all()


def test_gaussian_blur_matches_jax_and_scipy():
    img = np.random.default_rng(2).random((3, 40, 33)).astype(np.float32)
    got = device_aug._gaussian_blur(torch.from_numpy(img))
    for b in range(3):
        _close(got[b], jdevice_aug._gaussian_blur(jnp.asarray(img[b])))
        _close(got[b], ndimage.gaussian_filter(img[b], 1.0))


def _params(B, out, **active_ops):
    """Identity parameters (no op fires), ``active_ops`` switched on."""
    p = device_aug.sample_params(torch.Generator().manual_seed(0), B, 64,
                                 64, out)
    p["active"][:] = False
    p["flipud"][:] = p["fliplr"][:] = False
    p["scale"][:] = 1.0
    for k in ("rot", "shear", "trans", "jitter"):
        p[k][:] = 0.0
    return p


def test_device_augment_identity_categorical_and_deterministic():
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.random((6, 64, 64)).astype(np.float32))
    labs = torch.from_numpy(rng.integers(0, 4, (6, 64, 64)).astype(np.int32))
    gi, gl = device_aug.apply_params(_params(6, 64), imgs, labs, 64)
    assert torch.equal(gi, imgs) and torch.equal(gl, labs)
    a = device_aug.device_augment(torch.Generator().manual_seed(7), imgs,
                                  labs, 48)
    b = device_aug.device_augment(torch.Generator().manual_seed(7), imgs,
                                  labs, 48)
    c = device_aug.device_augment(torch.Generator().manual_seed(8), imgs,
                                  labs, 48)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (a[0] - c[0]).abs().max() > 0
    assert a[0].shape == (6, 48, 48) and a[1].dtype == torch.int32
    assert set(torch.unique(a[1]).tolist()) <= {0, 1, 2, 3}
    # per-step generators: a function of (seed, step) alone
    g1 = device_aug.step_generator(3, 17, torch.device("cpu"))
    g2 = device_aug.step_generator(3, 17, torch.device("cpu"))
    g3 = device_aug.step_generator(3, 18, torch.device("cpu"))
    r1, r2, r3 = (torch.rand(4, generator=g) for g in (g1, g2, g3))
    assert torch.equal(r1, r2) and not torch.equal(r1, r3)


def test_someof_count_distribution():
    """tests/test_device_aug.py's check: op count ~ Uniform{0..4}, each op
    active with P = 0.2, pairs as a uniform subset gives them."""
    trials = 4000
    masks = device_aug.someof_active(torch.Generator().manual_seed(0),
                                     trials).numpy()
    hist = np.bincount(masks.sum(1), minlength=6)
    assert hist[5:].sum() == 0
    np.testing.assert_allclose(hist[:5], trials / 5,
                               atol=5 * np.sqrt(trials * 0.2 * 0.8))
    np.testing.assert_allclose(masks.mean(0), 0.2, atol=0.04)
    pair = (masks[:, 0] & masks[:, 1]).mean()
    expect = sum((1 / 5) * (n * (n - 1)) / (10 * 9) for n in range(5))
    np.testing.assert_allclose(pair, expect, atol=0.02)


# --- the train step with on-device augmentation -----------------------------------

def test_train_step_device_aug_matches_external_aug():
    """JAX's test_train_step_device_aug_matches_external_aug: the step that
    augments on the device equals augmenting with the step's generator,
    normalising, and the plain step."""
    rng = np.random.default_rng(9)
    batch = {"image": torch.from_numpy(
                 rng.uniform(0, 1, (6, 64, 64, 1)).astype(np.float32)),
             "label": torch.from_numpy(
                 rng.integers(0, 4, (6, 64, 64)).astype(np.int32))}
    runs = []
    for fused in (True, False):
        model = build_model(num_classes=4, enc_name="gm_test", seed=0,
                            device="cpu").train()
        opt = make_optimizer(param_groups(model), 1e-4)
        step = make_train_step(model, opt, lambda s: 1e-3,
                               device_aug_size=32 if fused else None,
                               aug_seed=5)
        b = batch
        if not fused:
            gen = device_aug.step_generator(5, 0, torch.device("cpu"))
            img, lab = device_aug.device_augment(
                gen, batch["image"][..., 0], batch["label"], 32)
            b = {"image": ((img - 0.5) / 0.5)[..., None], "label": lab}
        loss = step(b, generator=torch.Generator().manual_seed(1))["loss"]
        runs.append((loss, model.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
