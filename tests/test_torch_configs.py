"""The configurations no other test builds, against the JAX package's, on
the CPU: GroupMamba's ``gm_small`` and ``gm_base`` (``models/groupmamba.py``
GROUPMAMBA_CONFIGS) and the legacy VSSM ``small_0229s``
(``models/vmamba.py`` VSSM_CONFIGS).

- Shapes, at full width and depth: every parameter's and buffer's shape,
  through the weight bridge's names, equals what the JAX model's
  ``jax.eval_shape`` gives (no full-size init on either side), and every
  quad block's per-group width stays within K1's ``kMaxD``
  (``csrc/quad_scan_ln.cu``).
- Numbers, at full width with one block per stage (``<name>_d1``, entries
  added to both packages' dicts for this module only): the port's seeded
  weights, with biases and BN statistics moved off their init values and
  the output head scaled so that the logits are O(1), carried to JAX by the
  JAX package's own converter (no JAX init to compile). Eval logits at 64x64
  b2 within ``tests/test_torch_model.py``'s LOGITS_TOL; for gm_base one
  train-mode step (the decoder's drop-path at 0): the loss at rtol 2e-4,
  every gradient at ``tests/test_torch_train.py``'s fp32 GRAD_TOL (atol
  1e-8 + 2e-3 * max|grad| per tensor), except the biases ahead of a
  train-mode BatchNorm, whose true gradient is 0 (the batch mean removes
  them) and which hold only rounding noise on both sides (up to 1.6e-8 here,
  past the 1e-8 floor): those are held to 0 within ZERO_GRAD of the largest
  gradient of the model; the BN running statistics at rtol 1e-5, atol 1e-6.
  JAX runs on
  ``scan_backend="assoc"``, the port the plain versions its ops take for
  CPU tensors.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceigm_unet_tpu import losses as jlosses
from ceigm_unet_tpu.convert.torch_import import convert_msvm_unet_state_dict
from ceigm_unet_tpu.models import emcad as jemcad
from ceigm_unet_tpu.models import groupmamba as jgroupmamba
from ceigm_unet_tpu.models import msvm_unet as jmsvm
from ceigm_unet_tpu.models import vmamba as jvm
from ceigm_unet_tpu_torch import losses
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.models import build_model, vmamba
from ceigm_unet_tpu_torch.models.groupmamba import GROUPMAMBA_CONFIGS
from ceigm_unet_tpu_torch.models.msvm_unet import MSVMUNet
from ceigm_unet_tpu_torch.models.ss2d import QuadGroupSS2D

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "ceigm_unet_tpu_torch" / "csrc"
# tests/test_torch_model.py's LOGITS_TOL; tests/test_torch_train.py's fp32
# GRAD_TOL (rtol, and atol / max|grad| per tensor)
LOGITS_TOL = dict(rtol=1e-3, atol=1e-3)
GRAD_TOL = (2e-3, 2e-3)
D1 = (1, 1, 1, 1)
HEAD_SCALE = 50.0       # max|logit| ~0.03 -> O(1)
# biases that feed a train-mode BatchNorm (LGAG's six branch convs and its
# psi conv, as chip_smoke.BN_CANCELLED), and how near 0 their gradients
# must be: a share of the model's largest gradient
BN_CANCELLED = re.compile(r"\.lgag\d\.(W_[gx]_\d|psi\.0)\.bias$")
ZERO_GRAD = 1e-6


@pytest.mark.parametrize("enc_name", ["gm_small", "gm_base", "small_0229s"])
def test_config_shapes_match_jax_and_fit_k1(enc_name):
    """Shapes against ``jax.eval_shape``; for a GroupMamba configuration
    also every quad block's per-group width within K1's ``kMaxD``. The
    legacy small_0229s (stage 3 of 20 blocks) goes through
    ``legacy_state_dict_from_jax`` (it scans on K10, which has no such
    bound)."""
    if enc_name in vmamba.VSSM_CONFIGS:
        depths = vmamba.VSSM_CONFIGS[enc_name]["depths"]
        assert depths == jvm.VSSM_CONFIGS[enc_name]["depths"] == (2, 2, 20, 2)
        jm = jvm.MSVMUNetLegacy(num_classes=9, enc_name=enc_name,
                                scan_backend="assoc")
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 1)))
        zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                       shapes)
        want = {k: a.shape for k, a in jax_import.legacy_state_dict_from_jax(
            zeros, depths).items()}
        sd = vmamba.MSVMUNetLegacy(num_classes=9, enc_name=enc_name
                                   ).state_dict()
        assert {k: tuple(t.shape) for k, t in sd.items()} == want
        assert sum(".layers.2.blocks." in k and k.endswith(".norm.weight")
                   for k in sd) == 20
        return
    cfg = GROUPMAMBA_CONFIGS[enc_name]
    jm = jmsvm.build_model(num_classes=9, enc_name=enc_name,
                           scan_backend="assoc")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 1)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    want = {k: a.shape for k, a in jax_import.state_dict_from_jax(
        zeros, depths=cfg["depths"]).items()}
    model = MSVMUNet(num_classes=9, enc_name=enc_name)
    got = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert got == want
    k_max_d = int(re.search(r"constexpr int kMaxD = (\d+);",
                            (CSRC / "quad_scan_ln.cu").read_text()).group(1))
    widths = {m.groups()[0].d_inner for m in model.modules()
              if isinstance(m, QuadGroupSS2D)}
    assert max(widths) <= k_max_d == 128
    assert max(widths) == {"gm_small": 128, "gm_base": 128}[enc_name]
    assert {"gm_small": 87, "gm_base": 106}[enc_name] in widths


@pytest.fixture(scope="module")
def depth1():
    """``<name>_d1`` in both packages' GROUPMAMBA_CONFIGS for this module:
    gm_small's and gm_base's widths, one block per stage."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("gm_small", "gm_base"):
            for configs in (GROUPMAMBA_CONFIGS, jgroupmamba.GROUPMAMBA_CONFIGS):
                mp.setitem(configs, f"{name}_d1", dict(configs[name],
                                                       depths=D1))
        yield


def _seeded(name, seed, **kw):
    """The port's ``name`` from ``seed`` with its biases and BN statistics
    moved and the output head scaled (strict load), and the same weights as
    JAX variables."""
    rng = np.random.default_rng(seed)
    model = build_model(num_classes=9, enc_name=name, device="cpu",
                        seed=seed, **kw)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    for k, v in sd.items():
        if k.endswith(("running_mean", ".bias")):
            sd[k] = v + rng.standard_normal(v.shape).astype(np.float32) * .05
        elif k.endswith("running_var"):
            sd[k] = v + rng.random(v.shape).astype(np.float32) * 0.3
    sd["decoder.out_head1.weight"] *= HEAD_SCALE
    jax_import.load_numpy_state_dict(model, sd)
    v = convert_msvm_unet_state_dict(sd, depths=D1)
    return model, jax.tree_util.tree_map(np.asarray, v)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 64, 64, 1)).astype(np.float32),
            rng.integers(0, 9, (2, 64, 64)).astype(np.int32))


@pytest.mark.parametrize("enc_name", ["gm_small", "gm_base"])
def test_config_logits_match_jax(depth1, enc_name):
    """Eval logits of the full-width, depth-1 model at 64x64 b2."""
    name = f"{enc_name}_d1"
    model, v = _seeded(name, 3)
    x, _ = _batch(4)
    jm = jmsvm.build_model(num_classes=9, enc_name=name,
                           scan_backend="assoc")
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 9)
    assert np.abs(want).max() > 0.3
    np.testing.assert_allclose(got, want, **LOGITS_TOL)


@pytest.fixture(scope="module")
def gm_base_step(depth1):
    """One train-mode step of JAX's gm_base_d1 at 64x64 b2 with the
    decoder's drop-path at 0 (EMCAD patched for this fixture only): the
    loss, every gradient and the new BN statistics, beside the port's model
    from the same weights (drop-path 0) and the batch."""
    name = "gm_base_d1"
    model, v = _seeded(name, 5, decoder_drop_path_rate=0.0)
    x, y = _batch(6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmsvm, "EMCAD", functools.partial(jemcad.EMCAD,
                                                     drop_path_rate=0.0))
        jm = jmsvm.build_model(num_classes=9, enc_name=name,
                               scan_backend="assoc")

        def loss_fn(params):
            logits, mut = jm.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, x,
                train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(1)})
            return jlosses.dice_ce_loss(logits, y, 0.4, 0.6), \
                mut["batch_stats"]
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"])
    return dict(model=model.train(), v=v, x=x, y=y, loss=float(loss),
                grads=jax.tree_util.tree_map(np.asarray, grads),
                stats=jax.tree_util.tree_map(np.asarray, stats))


def test_gm_base_train_step_matches_jax(gm_base_step):
    """The loss, every gradient, then the BN running statistics the step
    leaves."""
    d = gm_base_step
    model = d["model"]
    loss = losses.dice_ce_loss(model(torch.from_numpy(d["x"])),
                               torch.from_numpy(d["y"]).long(), 0.4, 0.6)
    loss.backward()
    np.testing.assert_allclose(loss.item(), d["loss"], rtol=2e-4)
    grads = jax_import.state_dict_from_jax(
        {"params": d["grads"], "batch_stats": d["v"]["batch_stats"]},
        depths=D1)
    rtol, floor = GRAD_TOL
    pairs = {name: ((p.grad if p.grad is not None
                     else torch.zeros_like(p)).numpy(),
                    np.asarray(grads[name], np.float32))
             for name, p in model.named_parameters()}
    # the bridge only moves values: the gradient tree and its bridged image
    # hold the same multiset of values
    np.testing.assert_array_equal(
        np.sort(np.concatenate([np.ravel(a) for a in
                                jax.tree_util.tree_leaves(d["grads"])])),
        np.sort(np.concatenate([np.ravel(w) for _, w in pairs.values()])))
    largest = max(np.abs(w).max() for _, w in pairs.values())
    cancelled = [n for n in pairs if BN_CANCELLED.search(n)]
    assert len(cancelled) == 3 * 7
    for name, (got, want) in pairs.items():
        assert got.shape == want.shape, name
        if name in cancelled:
            assert max(np.abs(got).max(), np.abs(want).max()) \
                <= ZERO_GRAD * largest, name
            continue
        scale = max(np.abs(want).max(), np.abs(got).max(), 1e-12)
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=1e-8 + floor * scale, err_msg=name)
    new = jax_import.state_dict_from_jax(
        {"params": d["v"]["params"], "batch_stats": d["stats"]}, depths=D1)
    stats = {k: b for k, b in model.named_buffers() if "running" in k}
    assert len(stats) == 2 * 12      # 3 stem + 3 EUCB + 3x2 LGAG BNs
    for name, b in stats.items():
        np.testing.assert_allclose(b.numpy(), new[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
