"""The port's debug guards (``utils/debug.py``) against the JAX package's
``utils/debug.py``, on the CPU.

The JAX side switches its guards on with ``CEIGM_DEBUG_NANCHECK`` /
``CEIGM_DEBUG_CAPTURE`` (set here with ``monkeypatch`` for the JAX side
only); the port builds its modules with a ``DebugGuards``. The JAX modules
run their TPU route (``scan_backend="pallas"``, Pallas in interpret mode)
where the guard sits on it, and ``"assoc"`` for the generic
``ssm_scan_core``. Captured tensors are held at the module tolerance of
tests/test_torch_vmamba.py (rtol 2e-4, atol 2e-4).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ceigm_unet_tpu.models import ss2d as jss2d
from ceigm_unet_tpu.utils import debug as jdebug
from ceigm_unet_tpu_torch import entry as tentry
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.models import (build_legacy_model, build_model,
                                         ss2d)
from ceigm_unet_tpu_torch.utils.debug import (DebugGuards, attach,
                                              check_nan_inf)

torch.set_num_threads(1)

MODULE_TOL = dict(rtol=2e-4, atol=2e-4)


class _Ops(TorchDispatchMode):
    """Records every aten op dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops(model, x):
    with torch.no_grad(), _Ops() as rec:
        model(x)
    return rec.ops


@pytest.mark.parametrize("legacy", [False, True])
def test_guards_off_add_no_op(legacy):
    """A model built without guards, and one with guards switched off, run
    the same ops; switched on, the nan check adds its reductions."""
    build = build_legacy_model if legacy else build_model
    name = "vssm_test" if legacy else "gm_test"
    x = torch.randn((1, 32, 32, 1), generator=torch.Generator().manual_seed(0))
    plain = build(enc_name=name, device="cpu")
    base = _ops(plain, x)
    off = _ops(build(enc_name=name, device="cpu", debug=DebugGuards()), x)
    assert off == base
    on = _ops(attach(plain, DebugGuards(nancheck=True)), x)
    assert len(on) > len(base)
    assert [o for o in on if "isnan" in o]


def _jax_init(module, seed, x):
    """Seeded values for the module's variable tree (tests/test_torch_
    vmamba.py's scales, from jax.eval_shape)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)

    def fill(path, s):
        name, shape = path[-1].key, s.shape
        if name in ("scale", "Ds"):
            a = 1.0 + rng.standard_normal(shape) * 0.1
        elif name == "A_logs":
            a = rng.standard_normal(shape) * 0.5
        elif name in ("kernel", "x_proj_weight", "dt_projs_weight",
                      "in_proj_weight", "out_proj_weight"):
            a = rng.standard_normal(shape) * shape[-2] ** -0.5
        else:
            a = rng.standard_normal(shape) * 0.3
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


# (tag, JAX module, port module, bridge): each guard on the route the
# JAX package puts it on
GUARDS = {
    "quad_pergroup.y": (
        lambda: jss2d.QuadGroupSS2D(dim=32, scan_backend="pallas"),
        lambda: ss2d.QuadGroupSS2D(32), jax_import.quad_ss2d),
    "quad_ssm_nhwc.y": (
        lambda: jss2d.SS2D(d_model=16, d_state=1, scan_backend="pallas"),
        lambda: ss2d.SS2D(16, d_state=1), jax_import.vssm_ss2d),
    "ssm_scan_core.ys": (
        lambda: jss2d.SS2D(d_model=16, d_state=2, scan_backend="assoc"),
        lambda: ss2d.SS2D(16, d_state=2), jax_import.vssm_ss2d),
}


def _pair(tag, x):
    jm_fn, m_fn, bridge = GUARDS[tag]
    jm = jm_fn()
    v = _jax_init(jm, 3, jnp.asarray(x))
    m = m_fn()
    jax_import.load_numpy_state_dict(m, bridge(v["params"]))
    return jm, v, m.eval()


@pytest.mark.parametrize("tag", list(GUARDS))
def test_a_planted_nan_raises_with_the_jax_tag(tag, monkeypatch):
    C = 32 if tag.startswith("quad_pergroup") else 16
    x = np.random.default_rng(1).standard_normal((2, 5, 6, C)).astype(
        np.float32)
    x[1, 2, 3, 0] = np.nan
    jm, v, m = _pair(tag, x)
    monkeypatch.setenv("CEIGM_DEBUG_NANCHECK", "1")
    with pytest.raises(Exception, match=f"check_nan_inf\\[{tag}\\]"):
        jax.block_until_ready(jax.jit(jm.apply)(v, jnp.asarray(x)))
    monkeypatch.delenv("CEIGM_DEBUG_NANCHECK")
    attach(m, DebugGuards(nancheck=True))
    with torch.no_grad(), pytest.raises(
            FloatingPointError, match=f"check_nan_inf\\[{tag}\\]: nan=True"):
        m(torch.from_numpy(x))
    # finite input: the guard passes the tensor through
    x[1, 2, 3, 0] = 0.0
    with torch.no_grad():
        assert torch.isfinite(m(torch.from_numpy(x))).all()


def test_quad_sandwich_out_guards_the_out_projection():
    """JAX's ``quad_sandwich.out`` (its batch-last layout's output) maps to
    QuadGroupSS2D's output: a NaN from the out-projection's weights, after
    the scan's guard, raises there."""
    m = attach(ss2d.QuadGroupSS2D(16), DebugGuards(nancheck=True))
    gen = torch.Generator().manual_seed(0)
    for g in m.groups():
        ss2d.init_ssm_params(g, gen)
        torch.nn.init.normal_(g.in_proj.weight, std=0.1)
        torch.nn.init.normal_(g.out_proj.weight, std=0.1)
    with torch.no_grad():
        m.mamba_g1.out_proj.weight[0, 0] = float("inf")
        with pytest.raises(FloatingPointError,
                           match=r"check_nan_inf\[quad_sandwich.out\]"):
            m(torch.randn(1, 4, 4, 16))
    with pytest.raises(FloatingPointError, match=r"\[t\]: nan=False inf=T"):
        check_nan_inf("t", torch.tensor([1.0, float("-inf")]))


def test_capture_matches_jax_captured(monkeypatch):
    x = np.random.default_rng(4).standard_normal((2, 5, 6, 16)).astype(
        np.float32)
    jm, v, m = _pair("ssm_scan_core.ys", x)
    monkeypatch.setenv("CEIGM_DEBUG_CAPTURE", "1")
    jdebug.CAPTURED.clear()
    jax.block_until_ready(jax.jit(jm.apply)(v, jnp.asarray(x)))
    monkeypatch.delenv("CEIGM_DEBUG_CAPTURE")
    want = {k: np.asarray(a) for k, a in jdebug.CAPTURED.items()}
    jdebug.CAPTURED.clear()
    guards = DebugGuards(capturing=True)
    with torch.no_grad():
        attach(m, guards)(torch.from_numpy(x))
    assert sorted(guards.captured) == sorted(want) == [
        f"ssm_scan_core.{k}" for k in ("Bs", "Cs", "dts", "us", "ys")]
    for k, a in want.items():
        got = guards.captured[k]
        assert got.device.type == "cpu" and tuple(got.shape) == a.shape, k
        np.testing.assert_allclose(got.numpy(), a, err_msg=k, **MODULE_TOL)
    # switched off, the same module captures nothing
    guards.captured.clear()
    guards.capturing = False
    with torch.no_grad():
        m(torch.from_numpy(x))
    assert guards.captured == {}


def test_build_functions_take_the_guards_off_by_default():
    for fn in (build_model, build_legacy_model, tentry.entry,
               tentry.legacy_entry):
        assert inspect.signature(fn).parameters["debug"].default is None
    guards = DebugGuards(nancheck=True)
    model = build_legacy_model(enc_name="vssm_test", device="cpu",
                               debug=guards)
    scans = [m for m in model.modules() if isinstance(m, ss2d.SS2D)]
    assert scans and all(m.debug is guards for m in scans)
    model, _ = tentry.entry("cpu", debug=guards)
    quads = [m for m in model.modules()
             if isinstance(m, ss2d.QuadGroupSS2D)]
    assert len(quads) == 26 and all(m.debug is guards for m in quads)
