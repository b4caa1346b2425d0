"""The port's training slice against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs its Pallas kernels in interpret mode (``scan2d``, the batch-last
``_scan2d_bl``) and its model on ``scan_backend="assoc"``; the port runs the
plain versions its ops take for CPU tensors, through the same
``torch.autograd.Function``s the card runs with the kernels.

Tolerances: fp32 gradients rtol 2e-3 and atol 2e-3 * max|grad| per tensor
(``tests/test_torch_grad_parity.py``); bf16 gradients rtol 3e-2 and atol
5e-2 * max|grad| (``tests/test_kernel_matrix.py``'s bf16 row); per-step
losses of the optimizer trajectory within 2e-4 * (1 + step)
(``docs/PARITY.md``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from ceigm_unet_tpu import losses as jlosses
from ceigm_unet_tpu.convert.torch_import import convert_msvm_unet_state_dict
from ceigm_unet_tpu.models import emcad as jemcad
from ceigm_unet_tpu.models import msvm_unet as jmsvm
from ceigm_unet_tpu.ops import grid_sample as jgs
from ceigm_unet_tpu.ops.ffn_pallas import custom_ffn_fused as jcffn
from ceigm_unet_tpu.ops.quad_scan import scan2d as jscan2d
from ceigm_unet_tpu.ops.quad_scan import sscan_quad_ln_cat
from ceigm_unet_tpu.ops.quad_scan_bl import _scan2d_bl, _scan2d_bl_adj
from ceigm_unet_tpu.train import config as jconfig
from ceigm_unet_tpu.train import lr_scheduler as jlr
from ceigm_unet_tpu.train import trainstep as jtrain
from ceigm_unet_tpu_torch import losses
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.models import build_model
from ceigm_unet_tpu_torch.models.emcad import LGAG
from ceigm_unet_tpu_torch.models.layers import BatchNorm2d, DropPath
from ceigm_unet_tpu_torch.ops.ffn import custom_ffn_fused
from ceigm_unet_tpu_torch.ops.grid_sample import dysample_grid_sample
from ceigm_unet_tpu_torch.ops.quad_scan import (_step_behind,
                                                quad_scan_ln_cat,
                                                quad_scan_ln_cat_ref, scan2d,
                                                scan2d_adjoint)
from ceigm_unet_tpu_torch.train import config, lr_scheduler, trainstep
from ceigm_unet_tpu_torch.train.trainstep import (cosine_lr, make_optimizer,
                                                  make_train_step,
                                                  param_groups)

torch.set_num_threads(1)

GRAD_TOL = {"float32": (2e-3, 2e-3), "bfloat16": (3e-2, 5e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GM_TEST_DEPTHS = (1, 1, 1, 1)


def _f32(a):
    a = a.float().detach().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, np.float32)


def _both(a, dtype="float32"):
    """numpy -> (jax array, torch tensor) with identical values."""
    j = jnp.asarray(a, JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def _close(got, want, dtype="float32", what=""):
    """Per-tensor gradient tolerance: rtol, and atol 1e-8 plus the floor
    scaled to the larger max|.| of the two (a bias ahead of a train-mode
    BatchNorm has a true gradient of 0 and holds only rounding noise)."""
    rtol, floor = GRAD_TOL[dtype]
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), np.abs(got).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-8 + floor * scale, err_msg=what)


# --- K8: the directional scan and its adjoint --------------------------------

@pytest.mark.parametrize("direction", [1, 2, 3, 4])
def test_scan2d_and_adjoint_match_jax(direction):
    """scan2d / scan2d_adjoint against the JAX scan2d and its VJP (Pallas
    K8 in interpret mode), and against the batch-last K9 (_scan2d_bl /
    _scan2d_bl_adj) after a transpose."""
    B, H, W, D = 2, 5, 7, 8
    rng = np.random.default_rng(direction)
    a = rng.uniform(0.5, 1.0, (B, H * W, D)).astype(np.float32)
    b = rng.standard_normal((B, H * W, D)).astype(np.float32)
    gh = rng.standard_normal((B, H * W, D)).astype(np.float32)
    h_j, vjp = jax.vjp(lambda a, b: jscan2d(a, b, H, W, direction),
                       jnp.asarray(a), jnp.asarray(b))
    da_j, db_j = vjp(jnp.asarray(gh))

    t = lambda x: torch.from_numpy(x)[:, None]            # (B, 1, L, D)
    dirs = (direction,)
    h = scan2d(t(a), t(b), H, W, dirs)
    g = scan2d_adjoint(t(a), t(gh), H, W, dirs)
    da = g * _step_behind(h, H, W, dirs)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h[:, 0].numpy(), np.asarray(h_j), **tol)
    np.testing.assert_allclose(g[:, 0].numpy(), np.asarray(db_j), **tol)
    np.testing.assert_allclose(da[:, 0].numpy(), np.asarray(da_j), **tol)

    bl = lambda x: jnp.asarray(x.transpose(2, 1, 0))      # (D, L, B)
    back = lambda x: np.asarray(x).transpose(2, 1, 0)
    h_bl = _scan2d_bl(bl(a), bl(b), H, W, direction, interpret=True)
    da_bl, db_bl = _scan2d_bl_adj(bl(a), h_bl, bl(gh), H, W, direction,
                                  interpret=True)
    np.testing.assert_allclose(h[:, 0].numpy(), back(h_bl), **tol)
    np.testing.assert_allclose(g[:, 0].numpy(), back(db_bl), **tol)
    np.testing.assert_allclose(da[:, 0].numpy(), back(da_bl), **tol)


# --- K1's backward: QuadScanLnCat --------------------------------------------

def _quad_inputs(B, H, W, D, seed):
    rng = np.random.default_rng(seed)
    K, L = 4, H * W
    return dict(
        u=rng.standard_normal((B, K, L, D)),
        dt=rng.standard_normal((B, K, L, D)) * 0.5,
        Bs=rng.standard_normal((B, K, L)),
        Cs=rng.standard_normal((B, K, L)),
        A=-np.exp(rng.standard_normal((K, D)) * 0.5),
        bias=rng.standard_normal((K, D)) * 0.3,
        Dv=rng.standard_normal((K, D)),
        lns=1.0 + rng.standard_normal((K, D)) * 0.1,
        lnb=rng.standard_normal((K, D)) * 0.1,
        go=rng.standard_normal((B, L, K * D)))


QUAD_NAMES = ("u", "dt", "Bs", "Cs", "A", "bias", "Dv", "lns", "lnb")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quad_scan_ln_cat_grads_match_jax(dtype):
    B, H, W, D = 2, 6, 5, 8
    dirs = (1, 2, 3, 4)
    a = _quad_inputs(B, H, W, D, seed=11)
    pair = {k: _both(a[k], dtype if k in ("u", "dt", "Bs", "Cs", "go")
                     else "float32") for k in (*QUAD_NAMES, "go")}
    _, vjp = jax.vjp(
        lambda u, dt, Bs, Cs, A, bias, Dv, s, b: sscan_quad_ln_cat(
            u, dt, Bs, Cs, A, bias, Dv, (s, b), H, W, dirs),
        *[pair[k][0] for k in QUAD_NAMES])
    want = vjp(pair["go"][0])
    args = [pair[k][1].clone().requires_grad_() for k in QUAD_NAMES]
    out = quad_scan_ln_cat(*args, H, W, dirs)
    out.backward(pair["go"][1])
    for name, t, w in zip(QUAD_NAMES, args, want):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
        _close(t.grad, w, dtype, what=f"d{name} {dtype}")


def test_quad_scan_ln_cat_backward_matches_autograd_of_plain_version():
    """The hand-written backward against torch autograd through
    quad_scan_ln_cat_ref, with the model's strided (B, L, K, D) views and
    permuted directions."""
    B, H, W, D = 2, 4, 7, 6
    dirs = (3, 1, 4, 2)
    a = {k: torch.from_numpy(np.asarray(v, np.float32))
         for k, v in _quad_inputs(B, H, W, D, seed=12).items()}
    blkd = lambda t: t.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    grads = []
    for fn, view in ((quad_scan_ln_cat, blkd), (quad_scan_ln_cat_ref,
                                                lambda t: t)):
        leaves = [a[k].clone().requires_grad_() for k in QUAD_NAMES]
        args = [view(leaves[0]), view(leaves[1]), *leaves[2:]]
        (fn(*args, H, W, dirs) * a["go"]).sum().backward()
        grads.append([t.grad for t in leaves])
    for name, got, want in zip(QUAD_NAMES, *grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5 * want.abs().max().item(),
                                   err_msg=f"d{name}")


# --- K3 and K4 backward ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_custom_ffn_fused_grads_match_jax(dtype):
    H, W, C, HID = 6, 7, 16, 64
    rng = np.random.default_rng(21)
    vals = dict(
        x=rng.standard_normal((2, H * W, C)),
        w1=rng.standard_normal((C, HID)) * 0.05,
        b1=rng.standard_normal(HID) * 0.1,
        dwk=rng.standard_normal((3, 3, 1, HID)) * 0.2,
        dwb=rng.standard_normal(HID) * 0.1,
        inck=rng.standard_normal((7, 7, 1, HID)) * 0.05,
        incb=rng.standard_normal(HID) * 0.1,
        w2=rng.standard_normal((HID, C)) * 0.05,
        b2=rng.standard_normal(C) * 0.1,
        go=rng.standard_normal((2, H * W, C)))
    names = ("x", "w1", "b1", "dwk", "dwb", "inck", "incb", "w2", "b2")
    pair = {k: _both(v, dtype if k in ("x", "w1", "w2", "go") else
                     "float32") for k, v in vals.items()}
    n_tap = 3 * (HID // 8)
    _, vjp = jax.vjp(lambda *a: jcffn(*a, H, W, n_tap),
                     *[pair[k][0] for k in names])
    want = vjp(pair["go"][0])
    args = [pair[k][1].clone().requires_grad_() for k in names]
    custom_ffn_fused(*args, H, W, n_tap).backward(pair["go"][1])
    for name, t, w in zip(names, args, want):
        _close(t.grad, w, dtype, what=f"d{name} {dtype}")


def test_dysample_grid_sample_grads_match_jax():
    """Including coordinates clamped at the border (1.5-pixel offsets put
    some samples outside the image): their gradient is zero on both
    sides."""
    B, H, W, C, g = 2, 6, 7, 16, 4
    rng = np.random.default_rng(22)
    jx, tx = _both(rng.standard_normal((B, H, W, C)))
    ys = (np.arange(2 * H) + 0.5) / H - 1
    xs = (np.arange(2 * W) + 0.5) / W - 1
    base = np.stack(np.meshgrid(xs, ys), -1)[None, :, :, None, :]
    grid = base + rng.standard_normal((B, 2 * H, 2 * W, g, 2)) * 1.5 / H
    jg, tg = _both(grid)
    go = rng.standard_normal((B, 2 * H, 2 * W, C))
    jgo, tgo = _both(go)
    _, vjp = jax.vjp(jgs.dysample_grid_sample, jx, jg)
    dx_j, dg_j = vjp(jgo)
    tx.requires_grad_()
    tg.requires_grad_()
    dysample_grid_sample(tx, tg).backward(tgo)
    _close(tx.grad, dx_j, what="dx")
    _close(tg.grad, dg_j, what="dgrid")
    outside = np.abs(grid[..., 0]) > 1 - 1 / (2 * W)
    assert outside.any()
    assert (tg.grad[..., 0].numpy()[outside] == 0).all()


# --- losses and LR schedules ------------------------------------------------

def _logits_labels(seed, B=2, H=9, W=11, C=9):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, C)).astype(np.float32) * 2,
            rng.integers(0, C, (B, H, W)))


@pytest.mark.parametrize("name", ["multiclass_dice_loss",
                                  "cross_entropy_loss", "focal_loss",
                                  "dice_ce_loss", "dice_focal_loss"])
def test_losses_match_jax(name):
    logits, labels = _logits_labels(1)
    jl = jnp.asarray(logits)
    tl = torch.from_numpy(logits).requires_grad_()
    want, grad = jax.value_and_grad(getattr(jlosses, name))(
        jl, jnp.asarray(labels))
    got = getattr(losses, name)(tl, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(grad), rtol=1e-4,
                               atol=1e-7)


def test_loss_options_and_make_loss_match_jax():
    logits, labels = _logits_labels(2)
    w = np.linspace(0.5, 1.5, 9).astype(np.float32)
    jl, jy, jw = jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w)
    tl, ty, tw = (torch.from_numpy(logits), torch.from_numpy(labels),
                  torch.from_numpy(w))
    pairs = [
        (jlosses.cross_entropy_loss(jl, jy, jw),
         losses.cross_entropy_loss(tl, ty, tw)),
        (jlosses.multiclass_dice_loss(jl, jy, jw),
         losses.multiclass_dice_loss(tl, ty, tw)),
        (jlosses.focal_loss(jl, jy, 1.5, 0.25),
         losses.focal_loss(tl, ty, 1.5, 0.25)),
        (jlosses.make_loss("DiceCELoss", ce_weight=0.4, dc_weight=0.6)(
            jl, jy), losses.make_loss("DiceCELoss", ce_weight=0.4,
                                      dc_weight=0.6)(tl, ty)),
        (jlosses.make_loss("DiceFocalLoss", fl_weight=0.5)(jl, jy),
         losses.make_loss("DiceFocalLoss", fl_weight=0.5)(tl, ty)),
        (jlosses.make_loss("DiceLoss")(jl, jy),
         losses.make_loss("DiceLoss")(tl, ty)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert set(losses.LOSSES) == set(jlosses.LOSSES)
    # bf16 logits are upcast inside
    bf = losses.dice_ce_loss(tl.bfloat16(), ty, 0.4, 0.6)
    assert bf.dtype == torch.float32
    with pytest.raises(KeyError):
        losses.make_loss("nope")


@pytest.mark.parametrize("name,kw", [
    ("CosineAnnealingLR", dict(t_max=7, eta_min=1e-6)),
    ("PolynomialLR", dict(total_iters=5, power=2.0)),
    ("CosineAnnealingWarmRestarts", dict(t_0=3, t_mult=1, eta_min=1e-5)),
    ("CosineAnnealingWarmRestarts", dict(t_0=2, t_mult=2, eta_min=0.0)),
])
def test_lr_schedules_match_jax(name, kw):
    # the JAX schedules compute in fp32: atol is 1e-6 of the base LR
    want = jlr.LR_SCHEDULERS[name](1e-3, 4, **kw)
    got = lr_scheduler.LR_SCHEDULERS[name](1e-3, 4, **kw)
    for step in (0, 1, 3, 4, 9, 17, 30, 55):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-9, err_msg=f"step {step}")
    cos_j = jtrain.cosine_lr(5e-4, 1e-6, 300, 46)
    cos_t = cosine_lr(5e-4, 1e-6, 300, 46)
    for step in (0, 45, 46, 1000, 13799):
        np.testing.assert_allclose(cos_t(step), float(cos_j(step)),
                                   rtol=1e-6, atol=5e-10)


@pytest.mark.parametrize("name,kw", [
    ("AdamW", dict(weight_decay=1e-2)),
    ("Adam", dict(weight_decay=1e-2)),
    ("SGD", dict(weight_decay=1e-2, momentum=0.9)),
    ("SGD", dict(momentum=0.9, nesterov=True)),
    ("RMSprop", dict(weight_decay=1e-2)),
])
def test_optimizers_match_jax(name, kw):
    """Four steps of each torch-semantic optimizer on the same gradients."""
    rng = np.random.default_rng(6)
    p0 = rng.standard_normal((3, 5)).astype(np.float32)
    grads = [rng.standard_normal((3, 5)).astype(np.float32)
             for _ in range(4)]
    lr = 1e-2
    tx = jtrain.OPTIMIZERS[name](lambda step: lr, **kw)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = trainstep.OPTIMIZERS[name]([p], **kw)
    opt.param_groups[0]["lr"] = lr
    for i, g in enumerate(grads):
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} step {i}")


def test_train_config_presets_match_jax():
    # scan_backend selects a TPU kernel family; the port has one path
    for port, ref in ((config.SYNAPSE_CONFIG, jconfig.SYNAPSE_CONFIG),
                      (config.ACDC_CONFIG, jconfig.ACDC_CONFIG)):
        want = dataclasses.asdict(ref)
        del want["scan_backend"]
        assert dataclasses.asdict(port) == want


# --- BatchNorm, LGAG and DropPath in training mode ---------------------------

def test_batchnorm_train_matches_flax():
    rng = np.random.default_rng(31)
    x = rng.standard_normal((3, 5, 6, 8)).astype(np.float32) * 2 + 0.5
    go = rng.standard_normal(x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.float32)
    params = {"scale": np.linspace(0.5, 1.5, 8, dtype=np.float32),
              "bias": np.linspace(-0.2, 0.3, 8, dtype=np.float32)}
    stats = {"mean": np.linspace(-1, 1, 8, dtype=np.float32),
             "var": np.linspace(0.5, 2, 8, dtype=np.float32)}
    v = {"params": params, "batch_stats": stats}

    def f(xx):
        return bn.apply(v, xx, mutable=["batch_stats"])
    want, new = f(jnp.asarray(x))
    _, vjp = jax.vjp(lambda xx: f(xx)[0], jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(go))

    m = BatchNorm2d(8)
    jax_import.load_numpy_state_dict(m, jax_import.batch_norm(params, stats))
    m.train()
    xt = torch.from_numpy(x).requires_grad_()
    out = m(xt)
    out.backward(torch.from_numpy(go))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-4,
                               atol=1e-5)
    bs = new["batch_stats"]
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(bs["mean"]),
                               rtol=1e-6, atol=1e-6)
    # the biased batch variance, as flax (torch's update is unbiased)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(bs["var"]),
                               rtol=1e-5, atol=1e-6)
    m.eval()
    with torch.no_grad():
        ev = m(torch.from_numpy(x))
    want_ev = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": params, "batch_stats": new["batch_stats"]},
        jnp.asarray(x))
    np.testing.assert_allclose(ev.numpy(), np.asarray(want_ev), rtol=1e-5,
                               atol=1e-5)


def test_lgag_train_matches_flax_with_double_bn_update():
    rng = np.random.default_rng(32)
    g = rng.standard_normal((2, 6, 9, 16)).astype(np.float32)
    x = rng.standard_normal((2, 6, 9, 16)).astype(np.float32)
    jm = jemcad.LGAG(f_int=8, groups=8)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(3), jnp.asarray(g), jnp.asarray(x)))
    v["batch_stats"]["bn"]["mean"] = rng.standard_normal(8).astype(
        np.float32) * 0.1
    v["batch_stats"]["bn"]["var"] = 1 + rng.random(8).astype(np.float32)
    want, new = jax.jit(lambda v, g, x: jm.apply(
        v, g, x, train=True, mutable=["batch_stats"]))(v, g, x)
    m = LGAG(8)
    jax_import.load_numpy_state_dict(m, jax_import.lgag(v["params"],
                                                        v["batch_stats"]))
    m.train()
    got = m(torch.from_numpy(g), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    nb = new["batch_stats"]
    for key, mod in (("bn", m.bn), ("psi_bn", m.psi[1])):
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   np.asarray(nb[key]["mean"]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
        np.testing.assert_allclose(mod.running_var.numpy(),
                                   np.asarray(nb[key]["var"]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    # the shared BN was updated twice, g branch then x branch
    with torch.no_grad():
        gt = torch.from_numpy(g)
        stats = [torch.var_mean(sum(c(gt) for c in convs).float(),
                                dim=(0, 1, 2), unbiased=False)
                 for convs in ((m.W_g_1, m.W_g_3, m.W_g_5),
                               (m.W_x_1, m.W_x_3, m.W_x_5))]
    r0 = torch.from_numpy(v["batch_stats"]["bn"]["mean"])
    twice = 0.9 * (0.9 * r0 + 0.1 * stats[0][1]) + 0.1 * stats[1][1]
    np.testing.assert_allclose(m.bn.running_mean.numpy(), twice.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_droppath_masks_scaling_and_generator():
    dp = DropPath(0.4).train()
    x = torch.ones((64, 3, 4, 5))
    y1 = dp(x, torch.Generator().manual_seed(5))
    y2 = dp(x, torch.Generator().manual_seed(5))
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    per = y1.reshape(64, -1)
    # one draw per sample: each sample is all 0 or all 1/keep
    assert ((per == 0).all(1) | (per == 1 / 0.6).all(1)).all()
    assert 0 < (per[:, 0] == 0).sum() < 64
    # the mask is uniform < keep, drawn in sample order
    u = torch.rand((64, 1, 1, 1), generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close((y1[:, :1, :1, :1] != 0), u < 0.6)
    # a generator with another seed draws other masks
    assert not torch.equal(dp(x, torch.Generator().manual_seed(9)), y1)
    with pytest.raises(ValueError, match="Generator"):
        dp(x)
    # eval, and rate 0, are the identity and need no generator
    assert dp.eval()(x) is x
    assert DropPath(0.0).train()(x) is x


# --- gm_test model: gradients, BN statistics, optimizer trajectory -----------

def _seeded_variables(seed):
    """JAX variables of the gm_test model, made from the port's seeded
    weights through the JAX package's own converter (no JAX init to
    compile), with BN statistics and biases moved off their init values."""
    rng = np.random.default_rng(seed)
    model = build_model(enc_name="gm_test", device="cpu", seed=seed)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    for k, v in sd.items():
        if k.endswith("running_mean") or k.endswith(".bias") \
                or k.endswith(".x"):
            sd[k] = v + rng.standard_normal(v.shape).astype(np.float32) * .05
        elif k.endswith("running_var"):
            sd[k] = v + rng.random(v.shape).astype(np.float32) * 0.3
    return jax.tree_util.tree_map(np.asarray, convert_msvm_unet_state_dict(
        sd, depths=GM_TEST_DEPTHS))


N_STEPS, N_FROZEN = 5, 2


@pytest.fixture(scope="module")
def gm_train():
    """The JAX gm_test model at 64x64, B=2, in training mode with the
    decoder's drop-path at 0 (EMCAD patched for this fixture only):
    perturbed variables, one batch, the loss, gradients and new batch
    statistics of one step, and the losses of N_STEPS AdamW steps with
    the encoder frozen for the first N_FROZEN."""
    rng = np.random.default_rng(41)
    x = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    y = rng.integers(0, 9, (2, 64, 64)).astype(np.int32)
    v = _seeded_variables(42)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmsvm, "EMCAD", functools.partial(jemcad.EMCAD,
                                                     drop_path_rate=0.0))
        jm = jmsvm.build_model(enc_name="gm_test", scan_backend="assoc")
        key = jax.random.PRNGKey(1)

        def loss_fn(params):
            logits, mut = jm.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, x,
                train=True, mutable=["batch_stats"], rngs={"dropout": key})
            return jlosses.dice_ce_loss(logits, y, 0.4, 0.6), \
                mut["batch_stats"]
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"])

        tx = jtrain.make_optimizer(jtrain.cosine_lr(5e-4, 1e-6, 4, 2), 1e-3)
        state = jtrain.TrainState(
            step=jnp.zeros((), jnp.int32), params=v["params"],
            batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
            tx=tx)
        step = jax.jit(jtrain.make_train_step(jm))
        traj = []
        for i in range(N_STEPS):
            state, m = step(state, {"image": x, "label": y}, key,
                            jnp.asarray(i < N_FROZEN))
            traj.append(float(m["loss"]))
    return dict(x=x, y=y, v=v, loss=float(loss),
                grads=jax.tree_util.tree_map(np.asarray, grads),
                stats=jax.tree_util.tree_map(np.asarray, stats), traj=traj)


def _port_model(v):
    model = build_model(enc_name="gm_test", device="cpu",
                        decoder_drop_path_rate=0.0)
    jax_import.load_numpy_state_dict(model, jax_import.state_dict_from_jax(
        v, depths=GM_TEST_DEPTHS))
    return model.train()


def test_gm_test_train_gradients_and_bn_stats_match_jax(gm_train):
    d = gm_train
    model = _port_model(d["v"])
    loss = losses.dice_ce_loss(model(torch.from_numpy(d["x"])),
                               torch.from_numpy(d["y"]).long(), 0.4, 0.6)
    loss.backward()
    np.testing.assert_allclose(loss.item(), d["loss"], rtol=2e-4, atol=2e-5)

    # the bridge only moves values (transposes, reshapes, slices): the
    # gradient tree and its bridged image hold the same multiset of values
    sd = jax_import.state_dict_from_jax(
        {"params": d["grads"], "batch_stats": d["v"]["batch_stats"]},
        depths=GM_TEST_DEPTHS)
    names = [n for n, _ in model.named_parameters()]
    leaves = jax.tree_util.tree_leaves(d["grads"])
    np.testing.assert_array_equal(
        np.sort(np.concatenate([np.ravel(a) for a in leaves])),
        np.sort(np.concatenate([np.ravel(sd[n]) for n in names])))

    for name, p in model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(got, sd[name], what=name)

    new_sd = jax_import.state_dict_from_jax(
        {"params": d["v"]["params"], "batch_stats": d["stats"]},
        depths=GM_TEST_DEPTHS)
    stats = {k: b for k, b in model.named_buffers() if "running" in k}
    assert len(stats) == 2 * 12      # 3 stem + 3 EUCB + 3x2 LGAG BNs
    for name, b in stats.items():
        np.testing.assert_allclose(b.numpy(), new_sd[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_gm_test_adamw_trajectory_with_encoder_freeze_matches_jax(gm_train):
    d = gm_train
    model = _port_model(d["v"])
    enc0 = {n: p.detach().clone() for n, p in
            model.encoder.named_parameters()}
    opt = make_optimizer(param_groups(model), 1e-3)
    step = make_train_step(model, opt, cosine_lr(5e-4, 1e-6, 4, 2))
    batch = {"image": torch.from_numpy(d["x"]),
             "label": torch.from_numpy(d["y"]).long()}
    for i in range(N_STEPS):
        loss = step(batch, freeze_encoder=i < N_FROZEN)["loss"].item()
        tol = 2e-4 * (1 + i)
        assert abs(loss - d["traj"][i]) <= tol * max(1.0, abs(loss)), (
            f"step {i}: port {loss} vs jax {d['traj'][i]} (tol {tol})")
        enc = dict(model.encoder.named_parameters())
        if i == N_FROZEN - 1:
            for n, p in enc0.items():
                assert torch.equal(enc[n], p), f"{n} moved while frozen"
    assert step.count == N_STEPS
    # Adam's step count advanced on the encoder while it was frozen
    first = next(model.encoder.parameters())
    assert int(opt.state[first]["step"]) == N_STEPS
    assert not all(torch.equal(enc[n], p0) for n, p0 in enc0.items())


def test_train_entry_defaults_to_the_card_and_steps_on_cpu():
    import inspect

    from ceigm_unet_tpu_torch.entry import train_entry
    for fn in (train_entry, build_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    model, step, batch = train_entry("cpu", batch=1, seed=3)
    assert model.training and next(model.parameters()).device.type == "cpu"
    assert batch["image"].shape == (1, 224, 224, 1)
    assert batch["label"].shape == (1, 224, 224)
    # blob-shaped labels: every class present, background the largest
    counts = torch.bincount(batch["label"].reshape(-1), minlength=9)
    assert (counts > 0).all() and counts.argmax() == 0
    enc0 = [p.detach().clone() for p in model.encoder.parameters()]
    loss = step(batch, freeze_encoder=True,
                generator=torch.Generator().manual_seed(0))["loss"]
    assert torch.isfinite(loss) and step.count == 1
    assert all(torch.equal(p, q)
               for p, q in zip(model.encoder.parameters(), enc0))
