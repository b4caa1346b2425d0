"""20-step training trajectories of the port against the JAX package, on
the CPU: gm_test (MSVM-UNet) at 32x32 and vssm_test (the legacy MSVM-UNet)
at 64x64, 9 classes, B 2, from the same weights (the port's seeded init
with biases, BN statistics, ``A_logs`` and ``Ds`` moved off their init
values, carried to JAX by its converter and back by the port's bridge), on
two seeded batches made with numpy and used alternately. vssm_test runs at
64x64, as tests/test_torch_legacy_train.py runs it: at 32x32 its deepest
maps are 1x1, and the train-mode BatchNorms there see two values a channel.

As tests/test_torch_grad_parity.py::test_training_trajectory_parity holds
the JAX package against the reference: 20 SGD and 20 AdamW steps at LR
1e-4 (AdamW weight decay 1e-4) with eval-mode normalization (running BN
statistics, drop-path off), which isolates the gradient and optimizer
trajectory. Then, per model, 20 steps of the recipe's train mode
(``make_train_step``): AdamW with weight decay 1e-3 on the per-epoch cosine
from the same LR 1e-4, the encoder frozen for the first 2 steps, drop-path
at 0, BN statistics updated by each batch. (From the fixtures' 5e-4, the
JAX package's own two scan backends, "assoc" and "ref", already part by
several times the loss tolerance and tens of times the logits tolerance
over 20 train-mode steps of vssm_test at 32x32: rounding alone,
compounded.)

In train mode the biases that feed a BatchNorm through linear maps only
have a true gradient of 0: the batch mean removes them, so they move
neither the loss nor any other gradient. Adam turns their rounding-noise
gradients into moves of up to a step, which differ between the two
packages and which the BN running means record. Before each of the port's
steps these biases take the values JAX's step starts from; the port's own
step of them is held apart: they are in the optimizer's groups at the
recipe's decay, and each step moves them by at most Adam's largest step at
that count (``_adam_step_bound``) times the LR, plus the decay.

The JAX side runs its models on ``scan_backend="assoc"``; its
``value_and_grad`` is jitted once per model and mode and shared by both
optimizers. Tolerances (``docs/PARITY.md``'s trajectory row): each step's
loss within 2e-4 * (1 + step) relative, the final eval logits at rtol
5e-3, atol 1e-6 + 5e-3 * max|logit|; the BN running statistics at the end
of the train-mode run at tests/test_torch_train.py's one-step BN tolerance
(rtol 1e-5, atol 1e-6) grown over the 20 steps as PARITY.md grows the
loss tolerance, times 1 + 20. Every parameter's move over the run (the norm
of final minus start; in train mode, but the biases above) within 2% of
JAX's, beside 20 ulps of the parameter and, where Adam steps, a thousandth
of a full step at every step (the move a gradient of rounding noise makes):
a step that does nothing, or an LR doubled from step 10, fails each of the
six cases.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ceigm_unet_tpu import losses as jlosses
from ceigm_unet_tpu.convert.torch_import import convert_msvm_unet_state_dict
from ceigm_unet_tpu.convert.vssm_import import convert_msvm_legacy_state_dict
from ceigm_unet_tpu.models import emcad as jemcad
from ceigm_unet_tpu.models import msvm_unet as jmsvm
from ceigm_unet_tpu.models import vmamba as jvm
from ceigm_unet_tpu.train import trainstep as jtrain
from ceigm_unet_tpu_torch import losses
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.models import build_legacy_model, build_model
from ceigm_unet_tpu_torch.train.trainstep import (cosine_lr, make_optimizer,
                                                  make_sgd, make_train_step,
                                                  param_groups)

torch.set_num_threads(1)

N_STEPS, N_FROZEN = 20, 2
BATCH, CLASSES = 2, 9
IMG = {"gm_test": 32, "vssm_test": 64}
LR, WD = 1e-4, 1e-4
# each parameter's move over a run (the norm of final minus start) against
# JAX's, relative to the move itself, beside fp32's rounding of the steps
MOVE_RTOL, FP32_EPS, ADAM_NOISE = 2e-2, 2.0 ** -23, 1e-3
# the train-mode recipe: AdamW with decay 1e-3 on a cosine over 10 epochs
# of 2 steps, so the 20 steps walk the whole schedule, from PARITY.md's LR
TRAIN_LR, TRAIN_WD = (1e-4, 1e-6, 10, 2), 1e-3
GM_TEST_DEPTHS = (1, 1, 1, 1)
VSSM_TEST_DEPTHS, DEC_DEPTHS = (1, 1, 1, 1), (2, 2, 2, 2)
# parameters and statistics moved off their init values
MOVED = ("bias", "running_mean", ".x", "A_logs", "Ds")
# biases whose only path to the loss runs into a train-mode BatchNorm
# (tests/test_torch_train.py's and tests/test_torch_legacy_train.py's)
BN_CANCELLED = {
    "gm_test": re.compile(r"\.lgag\d\.(W_[gx]_\d|psi\.0)\.bias$"),
    "vssm_test": re.compile(
        r"(decoder\.(layers\.\d\.up|out_layers\.0)\.expand\.0\.bias"
        r"|(decoder\.layers\.\d\.vss_layer\.blocks\.1|encoder\.layers\.3\."
        r"blocks\.0)\.mlp\.(fc2|multiscale_conv\.dwconv_(hw\.2|w\.1|h\.1))"
        r"\.bias)$"),
}


def _batches(img):
    rng = np.random.default_rng(13)
    xs = rng.standard_normal((2, BATCH, img, img, 1)).astype(np.float32)
    ys = rng.integers(0, CLASSES, (2, BATCH, img, img)).astype(np.int32)
    return xs, ys


def _moved(sd, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        v = v.numpy().copy()
        if k.endswith("running_var"):
            v = v + rng.random(v.shape).astype(np.float32) * 0.3
        elif k.endswith(MOVED):
            v = v + rng.standard_normal(v.shape).astype(np.float32) * 0.05
        out[k] = v
    return out


def _gm_test():
    sd = _moved(build_model(enc_name="gm_test", device="cpu",
                            seed=21).state_dict(), 22)
    variables = convert_msvm_unet_state_dict(sd, depths=GM_TEST_DEPTHS)

    def bridge(v):
        return jax_import.state_dict_from_jax(v, depths=GM_TEST_DEPTHS)

    def port(v):
        model = build_model(enc_name="gm_test", device="cpu",
                            decoder_drop_path_rate=0.0)
        jax_import.load_numpy_state_dict(model, bridge(v))
        return model

    def jax_model():
        return jmsvm.build_model(enc_name="gm_test", scan_backend="assoc")
    patch = (jmsvm, "EMCAD", functools.partial(jemcad.EMCAD,
                                               drop_path_rate=0.0))
    return variables, bridge, port, jax_model, patch


def _vssm_test():
    sd = _moved(build_legacy_model(enc_name="vssm_test", device="cpu",
                                   seed=31).state_dict(), 32)
    part = lambda pre: {k[len(pre):]: a for k, a in sd.items()
                        if k.startswith(pre)}
    variables = convert_msvm_legacy_state_dict(
        part("encoder."), part("decoder."), VSSM_TEST_DEPTHS, DEC_DEPTHS)

    def bridge(v):
        return jax_import.legacy_state_dict_from_jax(v, VSSM_TEST_DEPTHS,
                                                     DEC_DEPTHS)

    def port(v):
        model = build_legacy_model(enc_name="vssm_test", device="cpu",
                                   decoder_drop_path_rate=0.0)
        jax_import.load_numpy_state_dict(model, bridge(v))
        return model

    def jax_model():
        return jvm.MSVMUNetLegacy(num_classes=CLASSES, enc_name="vssm_test",
                                  scan_backend="assoc")
    patch = (jvm, "LegacyDecoder", functools.partial(jvm.LegacyDecoder,
                                                      drop_path_rate=0.0))
    return variables, bridge, port, jax_model, patch


MODELS = {"gm_test": _gm_test, "vssm_test": _vssm_test}
JAX_OPTIMIZERS = {
    "sgd": lambda: optax.sgd(LR),
    "adamw": lambda: jtrain.make_optimizer(lambda step: LR, WD),
}


@pytest.fixture(scope="module", params=list(MODELS))
def jax_runs(request):
    """The JAX trajectories of one model: per optimizer, the eval-mode
    losses and final logits; the train-mode losses, final eval logits, BN
    statistics (as the port's state_dict) and, per step, the values of the
    biases BN_CANCELLED names that the step starts from."""
    name = request.param
    variables, bridge, port, jax_model, patch = MODELS[name]()
    variables = jax.tree_util.tree_map(np.asarray, variables)
    out = {"img": IMG[name], "variables": variables, "port": port,
           "cancelled": BN_CANCELLED[name], "start": _numpy(bridge(variables))}
    xs, ys = _batches(IMG[name])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(*patch)
        m = jax_model()

        def loss_fn(params, stats, x, y):
            logits = m.apply({"params": params, "batch_stats": stats}, x,
                             train=False)
            return jlosses.dice_ce_loss(logits, y, 0.4, 0.6), logits
        value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        stats0 = variables["batch_stats"]
        for opt, make in JAX_OPTIMIZERS.items():
            tx = make()

            @jax.jit
            def update(grads, opt_state, params):
                updates, opt_state = tx.update(grads, opt_state, params)
                return optax.apply_updates(params, updates), opt_state
            params = variables["params"]
            opt_state = tx.init(params)
            traj = []
            for i in range(N_STEPS):
                (loss, _), grads = value_and_grad(params, stats0, xs[i % 2],
                                                  ys[i % 2])
                params, opt_state = update(grads, opt_state, params)
                traj.append(float(loss))
            (_, logits), _ = value_and_grad(params, stats0, xs[0], ys[0])
            out[opt] = (traj, np.asarray(logits), _numpy(bridge(
                {"params": params, "batch_stats": stats0})))

        tx = jtrain.make_optimizer(jtrain.cosine_lr(*TRAIN_LR), TRAIN_WD)
        state = jtrain.TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=stats0, opt_state=tx.init(variables["params"]),
            tx=tx)
        step = jax.jit(jtrain.make_train_step(m))
        key = jax.random.PRNGKey(1)
        traj, cancelled = [], []
        for i in range(N_STEPS):
            sd = bridge({"params": state.params, "batch_stats": stats0})
            cancelled.append({k: np.asarray(a) for k, a in sd.items()
                              if BN_CANCELLED[name].search(k)})
            state, metrics = step(
                state, {"image": xs[i % 2], "label": ys[i % 2]}, key,
                jnp.asarray(i < N_FROZEN))
            traj.append(float(metrics["loss"]))
        (_, logits), _ = value_and_grad(state.params, state.batch_stats,
                                        xs[0], ys[0])
        out["train"] = (traj, np.asarray(logits), cancelled, _numpy(bridge(
            {"params": state.params, "batch_stats": state.batch_stats})))
    return out


def _numpy(sd):
    return {k: np.asarray(a) for k, a in sd.items()}


def _logits(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


def _check(got, want, what, start, adam_lrs=None, skip=None):
    """got: the port's (losses, final logits, final state_dict, BN running
    statistics or None); want: JAX's (the same, its final state bridged to
    the port's names); start: the state both started from. The BN
    statistics are running averages over the 20 steps, so their one-step
    tolerance grows with the steps as PARITY.md's loss tolerance does: rtol
    and atol times 1 + N_STEPS. Each parameter's move over the run (the norm
    of final minus start) within MOVE_RTOL of JAX's move, but those
    ``skip`` matches; ``adam_lrs``: the LR of each step, where Adam
    steps."""
    (lp, gp, fp, sp), (lj, gj, fj, sj) = got, want
    for i in range(N_STEPS):
        tol = 2e-4 * (1 + i)
        assert abs(lp[i] - lj[i]) <= tol * max(1.0, abs(lj[i])), (
            f"{what}, step {i}: port {lp[i]} vs jax {lj[i]} (tol {tol})")
    np.testing.assert_allclose(gp, gj, rtol=5e-3,
                               atol=1e-6 + 5e-3 * np.abs(gj).max(),
                               err_msg=f"final logits after {what}")
    moved = 0
    for name, p in fp.items():
        if skip is not None and skip.search(name):
            continue
        dp, dj = (np.linalg.norm((v - start[name]).astype(np.float64))
                  for v in (p, fj[name]))
        # fp32 rounds each element's step to the parameter's ulp: up to
        # N_STEPS ulps of the largest element over the run; and Adam turns
        # a gradient of rounding noise into a step of up to the LR per
        # element either way: a move within ADAM_NOISE of such steps at
        # every step is made by noise
        atol = N_STEPS * FP32_EPS * float(np.abs(start[name]).max())
        if adam_lrs is not None:
            atol += ADAM_NOISE * sum(adam_lrs) * np.sqrt(p.size)
        assert abs(dp - dj) <= MOVE_RTOL * dj + atol, (
            f"{name} after {what}: the port moved it by {dp:.6e}, JAX by "
            f"{dj:.6e} (rounding {atol:.1e})")
        moved += dj > atol
    assert moved > 0, f"no parameter moved past rounding in {what}"
    if sp is not None:
        assert sp.keys() and sp.keys() <= sj.keys()
        for name, b in sp.items():
            np.testing.assert_allclose(b, sj[name], rtol=1e-5 * (1 + N_STEPS),
                                       atol=1e-6 * (1 + N_STEPS),
                                       err_msg=f"{name} after {what}")


def _eval_run(jax_runs, opt):
    model = jax_runs["port"](jax_runs["variables"]).eval()
    xs, ys = _batches(jax_runs["img"])
    params = list(model.parameters())
    optimizer = (make_sgd(params) if opt == "sgd"
                 else make_optimizer(params, WD))
    for group in optimizer.param_groups:
        group["lr"] = LR
    traj = []
    for i in range(N_STEPS):
        optimizer.zero_grad(set_to_none=True)
        loss = losses.dice_ce_loss(
            model(torch.from_numpy(xs[i % 2])),
            torch.from_numpy(ys[i % 2]).long(), 0.4, 0.6)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        traj.append(loss.item())
    return traj, _logits(model, xs[0]), _params(model), None


def _params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _adam_step_bound(t, b1=0.9, b2=0.999):
    """The largest |m_hat| / sqrt(v_hat) that Adam reaches at its t-th step
    over any gradient sequence: by Cauchy-Schwarz, sqrt(sum_k w_k^2 / u_k)
    with m_hat = sum_k w_k g_k and v_hat = sum_k u_k g_k^2."""
    w = [(1 - b1) * b1 ** (t - k) / (1 - b1 ** t) for k in range(1, t + 1)]
    u = [(1 - b2) * b2 ** (t - k) / (1 - b2 ** t) for k in range(1, t + 1)]
    return float(np.sqrt(sum(a * a / c for a, c in zip(w, u))))


def _train_run(jax_runs):
    model = jax_runs["port"](jax_runs["variables"])
    cancelled = jax_runs["train"][2]
    params = dict(model.named_parameters())
    assert set(cancelled[0]) == {
        n for n in params if jax_runs["cancelled"].search(n)} != set()
    enc0 = [p.detach().clone() for p in model.encoder.parameters()]
    optimizer = make_optimizer(param_groups(model), TRAIN_WD)
    # the cancelled biases are the optimizer's, each in a group decaying at
    # the recipe's rate once unfrozen
    groups = {id(p): g for g in optimizer.param_groups for p in g["params"]}
    assert all(groups[id(params[n])]["weight_decay"] == TRAIN_WD
               for n in cancelled[0])
    schedule = cosine_lr(*TRAIN_LR)
    step = make_train_step(model, optimizer, schedule)
    xs, ys = _batches(jax_runs["img"])
    traj = []
    for i in range(N_STEPS):
        batch = {"image": torch.from_numpy(xs[i % 2]),
                 "label": torch.from_numpy(ys[i % 2]).long()}
        with torch.no_grad():
            for n, a in cancelled[i].items():
                params[n].copy_(torch.from_numpy(a))
        traj.append(step(batch, freeze_encoder=i < N_FROZEN)["loss"].item())
        # the port's own step of the cancelled biases: AdamW's decay and a
        # move of at most Adam's largest step at this count, at this LR
        lr, bound = schedule(i), _adam_step_bound(i + 1)
        for n, a in cancelled[i].items():
            frozen = i < N_FROZEN and n.startswith("encoder.")
            b = params[n].detach().numpy()
            move = np.abs(b - a)
            assert not frozen or np.array_equal(b, a), n
            # plus two ulps of the parameter, its rounding
            limit = (lr * (bound + TRAIN_WD * np.abs(a))
                     + 2 * FP32_EPS * np.abs(a))
            assert (move <= limit).all(), (
                f"{n}: step {i} moved it by {move.max():.3e}, past Adam's "
                f"step {bound:.3f} x LR {lr:.3e} plus decay")
        if i == N_FROZEN - 1:
            assert all(torch.equal(p, q) for p, q in zip(
                model.encoder.parameters(), enc0)), "encoder moved frozen"
    running = {k: b.numpy().copy() for k, b in model.named_buffers()
               if "running" in k}
    return traj, _logits(model, xs[0]), _params(model), running


@pytest.mark.parametrize("opt", list(JAX_OPTIMIZERS))
def test_eval_mode_trajectory_matches_jax(jax_runs, opt):
    """20 SGD or AdamW steps at LR 1e-4 with eval-mode normalization: each
    step's loss, the final logits and every parameter's move against
    JAX's."""
    _check(_eval_run(jax_runs, opt), (*jax_runs[opt], None),
           f"{N_STEPS} {opt} steps", jax_runs["start"],
           [LR] * N_STEPS if opt == "adamw" else None)


def test_train_mode_trajectory_with_encoder_freeze_matches_jax(jax_runs):
    """The recipe's step (``make_train_step``: AdamW, cosine LR, train-mode
    BN) for 2 frozen and 18 unfrozen steps: each loss, the encoder bitwise
    unchanged through the frozen steps, the final logits and the BN running
    statistics against JAX's ``make_train_step`` (the biases that feed a
    BatchNorm only set to JAX's values before each step; see the module
    docstring)."""
    want, logits, _, final = jax_runs["train"]
    _check(_train_run(jax_runs), (want, logits, final, final),
           f"{N_STEPS} train-mode steps", jax_runs["start"],
           [cosine_lr(*TRAIN_LR)(i) for i in range(N_STEPS)],
           jax_runs["cancelled"])
