"""The port's legacy MSVM-UNet training slice against the JAX package, on
the CPU: the backward of ``sscan_dir`` (K10's, through K8) and of
``selective_scan`` (through K11), the vssm_test legacy model in training
mode, ``legacy_train_entry``; and the three trainer repairs (the warm-restart
cycle count, the frozen encoder's optimizer moments, ``train_entry``'s
sibling).

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs its Pallas kernels in interpret mode (``sscan_dir`` with its own
``_sscan_bwd``, ``scan_pallas``) and its model on ``scan_backend="assoc"``;
the port runs, for CPU tensors, the same autograd Functions and backward
formulas the card runs, with the plain versions in place of the kernels.

Tolerances: ``sscan_dir``'s grads those of tests/test_kernel_matrix.py
(fp32 rtol 6e-4 / atol 2e-3, the weight grads dA, dbias, dD 1e-3 / 1e-3;
bf16 3e-2 / 5e-2; atol scaled by max(1, max|grad|)); ``selective_scan``'s
those of tests/test_selective_scan.py's GRAD_TOLS (fp32 rtol 6e-4 / atol
3e-3, bf16 6e-2 / 1e-1, atol scaled the same way); the model's gradients
tests/test_torch_train.py's GRAD_TOL (rtol 2e-3, atol 2e-3 * max|grad| per
tensor) and its trajectory within 2e-4 * (1 + step) (``docs/PARITY.md``).
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceigm_unet_tpu import losses as jlosses
from ceigm_unet_tpu.convert.vssm_import import convert_msvm_legacy_state_dict
from ceigm_unet_tpu.models import vmamba as jvm
from ceigm_unet_tpu.ops.quad_scan import sscan_dir as jsscan_dir
from ceigm_unet_tpu.ops.selective_scan import selective_scan as jselscan
from ceigm_unet_tpu.train import trainstep as jtrain
from ceigm_unet_tpu_torch import losses
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.models import build_legacy_model
from ceigm_unet_tpu_torch.ops.quad_scan import sscan_dir, sscan_dir_ref
from ceigm_unet_tpu_torch.ops.selective_scan import selective_scan
from ceigm_unet_tpu_torch.train import lr_scheduler, trainstep
from ceigm_unet_tpu_torch.train.trainstep import (cosine_lr, make_optimizer,
                                                  make_train_step,
                                                  param_groups)

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SSCAN_TOL = {"float32": (6e-4, 2e-3), "bfloat16": (3e-2, 5e-2)}
SSCAN_TOLW = {"float32": (1e-3, 1e-3), "bfloat16": (3e-2, 5e-2)}
SS_GRAD_TOL = {"float32": (6e-4, 3e-3), "bfloat16": (6e-2, 1e-1)}
GRAD_TOL = (2e-3, 2e-3)
VSSM_TEST_DEPTHS = (1, 1, 1, 1)
DEC_DEPTHS = (2, 2, 2, 2)


def _f32(a):
    a = a.float().detach().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, np.float32)


def _both(a, dtype="float32"):
    """numpy -> (jax array, torch tensor) with identical values."""
    j = jnp.asarray(a, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _close_scaled(got, want, tol, what):
    """rtol, and atol scaled by max(1, max|want|)."""
    rtol, atol = tol
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, np.abs(want).max()),
                               err_msg=what)


# --- sscan_dir's backward: K10's, through K8 ------------------------------------

SSCAN_NAMES = ("u", "dt", "Bs", "Cs", "A", "bias", "Dv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sscan_dir_grads_match_jax_per_direction(dtype):
    """All seven grads of the four-direction op, u a stride-0 view over K,
    on a non-square 6x8 map (an H/W slip in directions 2 and 4 shows),
    against jax.vjp of the JAX op run once per direction (Pallas in
    interpret mode, its own _sscan_bwd); du sums over the directions on
    both sides."""
    B, H, W, D = 2, 6, 8, 40
    dirs = (1, 2, 3, 4)
    K, L = len(dirs), H * W
    rng = np.random.default_rng(D)
    raw = dict(u=rng.standard_normal((B, L, D)),
               dt=rng.standard_normal((B, K, L, D)) * 0.5,
               Bs=rng.standard_normal((B, K, L)),
               Cs=rng.standard_normal((B, K, L)),
               A=-np.exp(rng.standard_normal((K, D)) * 0.5),
               bias=rng.standard_normal((K, D)) * 0.3,
               Dv=rng.standard_normal((K, D)))
    low = ("u", "dt", "Bs", "Cs")
    pair = {k: _both(v, dtype if k in low else "float32")
            for k, v in raw.items()}
    gy = rng.standard_normal((B, K, L, D)).astype(np.float32)

    def jfn(u, dt, Bs, Cs, A, bias, Dv):
        bc = lambda x, k: jnp.broadcast_to(x[:, k, :, None], (B, L, D))
        return jnp.stack([jsscan_dir(u, dt[:, k], bc(Bs, k), bc(Cs, k), A[k],
                                     bias[k], Dv[k], H, W, d)
                          for k, d in enumerate(dirs)], axis=1)
    _, vjp = jax.vjp(jfn, *[pair[k][0] for k in SSCAN_NAMES])
    want = vjp(jnp.asarray(gy))

    leaves = [pair[k][1].clone().requires_grad_() for k in SSCAN_NAMES]
    u = leaves[0][:, None].expand(B, K, L, D)
    assert u.stride(1) == 0
    sscan_dir(u, *leaves[1:], H, W, dirs).backward(torch.from_numpy(gy))
    for name, t, w in zip(SSCAN_NAMES, leaves, want):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
        tol = (SSCAN_TOLW if name in ("A", "bias", "Dv") else SSCAN_TOL)
        _close_scaled(t.grad, w, tol[dtype], f"d{name} {dtype}")


def test_sscan_dir_backward_matches_autograd_of_plain_version():
    """The hand-written backward against torch autograd through
    sscan_dir_ref, with the model's strided (K, B, L, D) dt view and
    permuted directions."""
    B, H, W, D = 2, 5, 7, 6
    dirs = (3, 1, 4, 2)
    K, L = 4, H * W
    g = torch.Generator().manual_seed(3)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g) * scale
    base = [r(B, L, D), r(B, K, L, D, scale=0.5), r(B, K, L), r(B, K, L),
            -torch.exp(r(K, D, scale=0.5)), r(K, D, scale=0.3), r(K, D)]
    gy = r(B, K, L, D)
    kb = lambda t: t.permute(1, 0, 2, 3).contiguous().permute(1, 0, 2, 3)
    grads = []
    for fn, view in ((sscan_dir, kb), (sscan_dir_ref, lambda t: t)):
        leaves = [t.clone().requires_grad_() for t in base]
        u = leaves[0][:, None].expand(B, K, L, D)
        (fn(u, view(leaves[1]), *leaves[2:], H, W, dirs) * gy).sum() \
            .backward()
        grads.append([t.grad for t in leaves])
    for name, got, want in zip(SSCAN_NAMES, *grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5 * want.abs().max().item(),
                                   err_msg=f"d{name}")


# --- selective_scan's backward: through K11 ------------------------------------

SS_NAMES = ("u", "delta", "A", "B", "C", "D", "bias")
# (N, G, B/C 4-D, D, delta_bias, softplus, last state, in dtype)
SS_GRAD_CASES = [
    (1, 1, False, True, True, True, False, "float32"),    # K12 forward
    (1, 4, True, True, False, True, False, "float32"),    # K12 forward
    (1, 4, True, False, True, True, False, "bfloat16"),   # K12 forward
    (1, 1, False, True, True, False, False, "float32"),   # K11 forward
    (1, 4, True, True, True, True, True, "float32"),      # K11, last state
    (16, 1, False, True, True, True, False, "float32"),
    (16, 4, True, False, False, True, False, "float32"),
    (16, 4, True, True, True, False, True, "float32"),
    (16, 1, False, True, True, True, False, "bfloat16"),
]


@pytest.mark.parametrize("case", SS_GRAD_CASES)
def test_selective_scan_grads_match_jax(case):
    """The op's seven grads (None stays None) against jax.vjp of the JAX op
    on its "pallas" backend (scan_pallas in interpret mode inside its
    _bwd_rule; with return_last_state, autodiff through assoc) and its
    "ref" backend."""
    N, G, four_d, with_D, with_bias, softplus, last, dtype = case
    rng = np.random.default_rng(N * 10 + G)
    batch, dim, L = 2, 8, 65
    bc = (batch, G, N, L) if four_d else (batch, N, L)
    raw = dict(u=rng.standard_normal((batch, dim, L)),
               delta=rng.standard_normal((batch, dim, L)) * 0.5,
               A=-np.exp(rng.standard_normal((dim, N)) * 0.5),
               B=rng.standard_normal(bc), C=rng.standard_normal(bc),
               D=rng.standard_normal(dim) if with_D else None,
               bias=rng.standard_normal(dim) * 0.3 if with_bias else None)
    if not softplus:
        raw["delta"] = np.abs(raw["delta"])
        if with_bias:
            raw["bias"] = np.abs(raw["bias"])
    low = ("u", "delta", "B", "C")
    pair = {k: (None, None) if v is None else
            _both(v, dtype if k in low else "float32")
            for k, v in raw.items()}
    gy = rng.standard_normal((batch, dim, L)).astype(np.float32)
    gh = rng.standard_normal((batch, dim, N)).astype(np.float32)
    live = [n for n in SS_NAMES if raw[n] is not None]

    leaves = {n: None if pair[n][1] is None else
              pair[n][1].clone().requires_grad_() for n in SS_NAMES}
    out = selective_scan(*[leaves[n] for n in SS_NAMES],
                         delta_softplus=softplus, return_last_state=last,
                         out_dtype=torch.float32)
    loss = ((out[0] * torch.from_numpy(gy)).sum()
            + (out[1] * torch.from_numpy(gh)).sum() if last
            else (out * torch.from_numpy(gy)).sum())
    loss.backward()

    for backend in ("pallas", "ref"):
        def jloss(*args):
            kw = dict(zip(live, args))
            o = jselscan(*[kw.get(n) for n in SS_NAMES],
                         delta_softplus=softplus, return_last_state=last,
                         backend=backend, out_dtype=jnp.float32)
            if last:
                return jnp.sum(o[0] * gy) + jnp.sum(o[1] * gh)
            return jnp.sum(o * gy)
        want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(live)))))(
            *[pair[n][0] for n in live])
        for name, w in zip(live, want):
            t = leaves[name]
            assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
            _close_scaled(t.grad, w, SS_GRAD_TOL[dtype],
                          f"d{name} {backend} {case}")


# --- the vssm_test legacy model in training mode --------------------------------

N_STEPS, N_FROZEN = 5, 2
PERTURBED = ("bias", "running_mean", "A_logs", "Ds")
# vssm_test biases that add a per-channel constant ahead of a train-mode
# BatchNorm (the conv before each LKPE/FLKPE BN; the last modules of the
# last block whose output feeds one): the batch mean removes them, so their
# true gradient is 0 and each side holds only rounding noise
BN_CANCELLED = re.compile(
    r"(decoder\.(layers\.\d\.up|out_layers\.0)\.expand\.0\.bias"
    r"|(decoder\.layers\.\d\.vss_layer\.blocks\.1|encoder\.layers\.3\."
    r"blocks\.0)\.mlp\.(fc2|multiscale_conv\.dwconv_(hw\.2|w\.1|h\.1))"
    r"\.bias)$")


@pytest.fixture(scope="module")
def legacy_train():
    """The JAX MSVMUNetLegacy(vssm_test) at 64x64, B=2, on scan_backend
    "assoc", in training mode with the decoder's drop path at 0
    (LegacyDecoder patched for this fixture only; the vssm_test encoder's
    is 0): variables made from a seeded port model through the JAX
    package's converter (biases, BN statistics, A_logs and Ds moved off
    their init values), one batch, the loss, gradients and new batch
    statistics of one step, and the losses of N_STEPS AdamW steps with the
    encoder frozen for the first N_FROZEN."""
    rng = np.random.default_rng(51)
    x = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    y = rng.integers(0, 9, (2, 64, 64)).astype(np.int32)
    sd = {k: t.numpy().copy() for k, t in build_legacy_model(
        enc_name="vssm_test", device="cpu", seed=52).state_dict().items()}
    for k, a in sd.items():
        if k.endswith("running_var"):
            sd[k] = a + rng.random(a.shape).astype(np.float32) * 0.3
        elif k.endswith(PERTURBED):
            sd[k] = a + rng.standard_normal(a.shape).astype(np.float32) * .1
    part = lambda pre: {k[len(pre):]: a for k, a in sd.items()
                        if k.startswith(pre)}
    v = jax.tree_util.tree_map(np.asarray, convert_msvm_legacy_state_dict(
        part("encoder."), part("decoder."), VSSM_TEST_DEPTHS, DEC_DEPTHS))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvm, "LegacyDecoder", functools.partial(
            jvm.LegacyDecoder, drop_path_rate=0.0))
        jm = jvm.MSVMUNetLegacy(num_classes=9, enc_name="vssm_test",
                                scan_backend="assoc")
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
    model = build_legacy_model(enc_name="vssm_test", device="cpu",
                               decoder_drop_path_rate=0.0)
    jax_import.load_numpy_state_dict(model, jax_import.legacy_state_dict_from_jax(
        v, VSSM_TEST_DEPTHS, DEC_DEPTHS))
    return model.train()


def test_vssm_test_train_gradients_and_bn_stats_match_jax(legacy_train):
    d = legacy_train
    model = _port_model(d["v"])
    loss = losses.dice_ce_loss(model(torch.from_numpy(d["x"])),
                               torch.from_numpy(d["y"]).long(), 0.4, 0.6)
    loss.backward()
    np.testing.assert_allclose(loss.item(), d["loss"], rtol=2e-4, atol=2e-5)

    # the bridge only moves values: the gradient tree and its bridged image
    # hold the same multiset of values
    sd = jax_import.legacy_state_dict_from_jax(
        {"params": d["grads"], "batch_stats": d["v"]["batch_stats"]},
        VSSM_TEST_DEPTHS, DEC_DEPTHS)
    names = [n for n, _ in model.named_parameters()]
    np.testing.assert_array_equal(
        np.sort(np.concatenate([np.ravel(a) for a in
                                jax.tree_util.tree_leaves(d["grads"])])),
        np.sort(np.concatenate([np.ravel(sd[n]) for n in names])))

    rtol, floor = GRAD_TOL
    top = max(np.abs(a).max() for a in sd.values() if a.dtype.kind == "f")
    cancelled = 0
    for name, p in model.named_parameters():
        got = _f32(p.grad if p.grad is not None else torch.zeros_like(p))
        want = np.asarray(sd[name], np.float32)
        if BN_CANCELLED.search(name):
            cancelled += 1
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-4 * top
            continue
        scale = max(np.abs(want).max(), np.abs(got).max(), 1e-12)
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=1e-8 + floor * scale, err_msg=name)
    assert cancelled == 4 + 3 * 4 + 1

    new_sd = jax_import.legacy_state_dict_from_jax(
        {"params": d["v"]["params"], "batch_stats": d["stats"]},
        VSSM_TEST_DEPTHS, DEC_DEPTHS)
    stats = {k: b for k, b in model.named_buffers() if "running" in k}
    assert len(stats) == 2 * 4       # 3 LKPE + 1 FLKPE BNs
    for name, b in stats.items():
        np.testing.assert_allclose(b.numpy(), new_sd[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_vssm_test_adamw_trajectory_with_encoder_freeze_matches_jax(
        legacy_train):
    d = legacy_train
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
    assert not all(torch.equal(enc[n], p0) for n, p0 in enc0.items())


def test_legacy_train_entry_defaults_to_the_card_and_steps_on_cpu():
    import inspect

    from ceigm_unet_tpu_torch.entry import legacy_train_entry
    for fn in (legacy_train_entry, build_legacy_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    model, step, batch = legacy_train_entry("cpu", batch=1, seed=3)
    assert model.training and next(model.parameters()).device.type == "cpu"
    assert batch["image"].shape == (1, 224, 224, 1)
    enc0 = [p.detach().clone() for p in model.encoder.parameters()]
    gen = torch.Generator().manual_seed(0)
    loss = step(batch, freeze_encoder=True, generator=gen)["loss"]
    assert torch.isfinite(loss) and step.count == 1
    assert all(torch.equal(p, q)
               for p, q in zip(model.encoder.parameters(), enc0))
    # the frozen step differentiated the decoder only
    assert all(p.grad is not None and not bool(p.grad.any())
               for p in model.encoder.parameters())
    assert any(bool(p.grad.any()) for p in model.decoder.parameters())


# --- the trainer repairs: warm-restart cycles, frozen moments ------------------

@pytest.mark.parametrize("t_0", [1, 2, 3, 5, 10])
def test_cosine_warm_restarts_matches_torch_per_epoch(t_0):
    """Against torch's CosineAnnealingWarmRestarts stepped once per epoch,
    over T_mult 1, 2, 3, 5, 10 and 400 epochs: (T_0, T_mult, epoch) = (1,
    3, 121), (2, 3, 242), (3, 3, 363), (1, 10, 111), (2, 10, 222) and (3,
    10, 333) start a cycle where a float log of the cycle count lands one
    short."""
    for t_mult in (1, 2, 3, 5, 10):
        p = torch.nn.Parameter(torch.zeros(1))
        opt = torch.optim.SGD([p], lr=1e-3)
        ref = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(
            opt, T_0=t_0, T_mult=t_mult, eta_min=1e-6)
        got = lr_scheduler.cosine_annealing_warm_restarts(
            1e-3, 3, t_0, t_mult, 1e-6)
        for epoch in range(400):
            want = ref.get_last_lr()[0]
            for s in (3 * epoch, 3 * epoch + 2):
                assert abs(got(s) - want) <= 1e-12, (t_0, t_mult, epoch)
            opt.step()
            ref.step()


def _tiny_segmenter():
    """A model with a top-level ``encoder`` and NHWC logits, as
    make_train_step expects."""
    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = torch.nn.Linear(1, 4)
            self.decoder = torch.nn.Linear(4, 9)

        def forward(self, x, generator=None):
            return self.decoder(torch.relu(self.encoder(x)))
    torch.manual_seed(0)
    return Tiny()


MOMENTS = {"Adam": ("exp_avg", "exp_avg_sq"), "SGD": ("momentum_buffer",),
           "RMSprop": ("square_avg",)}


@pytest.mark.parametrize("name,kw", [
    ("Adam", dict(weight_decay=0.1)),
    ("SGD", dict(weight_decay=0.1, momentum=0.9)),
    ("RMSprop", dict(weight_decay=0.1)),
])
def test_frozen_encoder_moments_stay_zero_under_l2_decay(name, kw):
    """The port's freeze semantics (the reference trainer's, and the JAX
    trainer docstring's): with L2 decay inside the gradient, a frozen
    encoder's optimizer moments stay exactly 0 and its parameters do not
    move; the rest trains. (The JAX code feeds wd * p into the moments
    here; see train/trainstep.py.)"""
    model = _tiny_segmenter()
    enc0 = [p.detach().clone() for p in model.encoder.parameters()]
    opt = trainstep.OPTIMIZERS[name](param_groups(model), **kw)
    step = make_train_step(model, opt, lambda s: 1e-2)
    rng = np.random.default_rng(7)
    batch = {"image": torch.from_numpy(rng.standard_normal(
                 (2, 5, 6, 1)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 9, (2, 5, 6)))}
    for _ in range(3):
        step(batch, freeze_encoder=True)
    for p, p0 in zip(model.encoder.parameters(), enc0):
        assert torch.equal(p, p0)
        for key in MOMENTS[name]:
            assert not bool(opt.state[p][key].any()), key
    assert any(bool(opt.state[p][MOMENTS[name][0]].any())
               for p in model.decoder.parameters())
    step(batch, freeze_encoder=False)
    assert all(bool(opt.state[p][MOMENTS[name][0]].any())
               for p in model.encoder.parameters())
