"""The port's three kernel routes against the JAX package, on the CPU: the
single-grid grid-sample and DySample's per-group route (``CEIGM_GS_GROUP=0``;
K6/K7), the depthwise 3x3 with its flipped-tap transpose (``CEIGM_BLDW``;
K13) and the int8 quad scan (``CEIGM_QUANT=1``; K14). Each port op runs its
plain PyTorch version here; the JAX side runs its Pallas kernels in
interpret mode. Inputs are made with numpy from a seed and handed to both.
The hand-written kernels are held against these plain versions on a card by
tests/test_torch_cuda.py.

Tolerances: fp32 results 1e-5 (rtol and atol; the same arithmetic in
another order), fp32 gradients 1e-4 * max|JAX grad|; int8 values may differ
by one step in at most 0.1% of the elements (an fp32 difference at a
rounding tie) and by no more; bf16 outputs of the int8 scan 1e-2 * max (one
bf16 rounding of the same fp32 value, plus a flipped int8 step); module and
model outputs as stated at each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceigm_unet_tpu.ops.quad_scan as jquad_scan
import ceigm_unet_tpu_torch.models.ss2d as tss2d
from ceigm_unet_tpu.models import build_model as jbuild_model
from ceigm_unet_tpu.models.ss2d import QuadGroupSS2D as JQuadGroupSS2D
from ceigm_unet_tpu.ops import grid_sample as jgs
from ceigm_unet_tpu.ops.quad_scan_bl import dwconv_bl
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.models import build_model
from ceigm_unet_tpu_torch.models.ss2d import QuadGroupSS2D, q8
from ceigm_unet_tpu_torch.ops.dwconv import (dwconv3x3, dwconv3x3_flip,
                                             dwconv3x3_ref)
from ceigm_unet_tpu_torch.ops.grid_sample import (
    dysample_grid_sample_pergroup, dysample_grid_sample_ref,
    grid_sample_bilinear_fused)
from ceigm_unet_tpu_torch.ops.quad_scan import quad_scan_ln_cat_q8
from test_torch_model import (GM_TEST_DEPTHS, LOGITS_TOL, _init, _numpy_tree,
                              _perturb, _port, _t)

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(
        t, torch.Tensor) else t, np.float32)


# --- single-grid grid-sample (K6/K7) -----------------------------------------

def _local_grid(rng, B, H, W, Ho, Wo, wobble=0.75):
    """Normalised (B, Ho, Wo, 2) grid whose pixel coordinates stay within
    ``wobble`` of the nominal resampling (oy*H/Ho, ox*W/Wo): inside the
    banded TPU kernel's band."""
    oy = (np.arange(Ho) * H // Ho)[None, :, None]
    ox = (np.arange(Wo) * W // Wo)[None, None, :]
    py = oy + rng.uniform(-wobble, wobble, (B, Ho, Wo))
    px = ox + rng.uniform(-wobble, wobble, (B, Ho, Wo))
    return np.stack([(2.0 * px + 1.0) / W - 1.0, (2.0 * py + 1.0) / H - 1.0],
                    -1).astype(np.float32)


# (B, H, W, C, Ho, Wo): the banded kernel's geometry (2x, T = 4), and a
# non-2x output that only the dense kernel takes
@pytest.mark.parametrize("shape", [(2, 32, 32, 5, 64, 64),
                                   (2, 7, 9, 6, 11, 6)])
def test_grid_sample_bilinear_fused_matches_jax_kernels(shape):
    """In-band offsets only: the port computes the exact op, and K6 clamps
    coordinates outside its band to the band's edge (pinned by
    tests/test_grid_sample.py::test_banded_kernel_out_of_band_clamps), so
    the two agree only where no coordinate leaves the band."""
    B, H, W, C, Ho, Wo = shape
    rng = np.random.default_rng(C)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    grid = _local_grid(rng, B, H, W, Ho, Wo)
    got = grid_sample_bilinear_fused(torch.from_numpy(x),
                                     torch.from_numpy(grid))
    assert got.shape == (B, Ho, Wo, C) and got.dtype == torch.float32
    jx, jg = jnp.asarray(x), jnp.asarray(grid)
    wants = [jgs.grid_sample_bilinear_mm(jx, jg),
             jgs._gs_fused_impl(jx, jg, interpret=True)]
    if Ho == 2 * H and Wo == 2 * W:
        assert jgs._band_tile(Ho, Wo, H) is not None
        wants.append(jgs._gs_banded_impl(jx, jg, interpret=True))
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_grid_sample_bilinear_fused_grads_match_jax_vjp():
    rng = np.random.default_rng(1)
    B, H, W, C = 2, 6, 7, 5
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    grid = _local_grid(rng, B, H, W, 9, 13)
    go = rng.standard_normal((B, 9, 13, C)).astype(np.float32)
    tx, tg = (torch.from_numpy(a).requires_grad_() for a in (x, grid))
    grid_sample_bilinear_fused(tx, tg).backward(torch.from_numpy(go))
    _, vjp = jax.vjp(jgs.grid_sample_bilinear_mm, jnp.asarray(x),
                     jnp.asarray(grid))
    for got, want in zip((tx.grad, tg.grad), vjp(jnp.asarray(go))):
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dysample_pergroup_equals_grouped_route(dtype):
    """The per-group route (regroup, single-grid op, regroup back) and the
    grouped op's plain version are one function."""
    rng = np.random.default_rng(2)
    B, H, W, C, g = 2, 5, 6, 12, 4
    x = torch.from_numpy(rng.standard_normal((B, H, W, C))).to(dtype)
    grid = torch.from_numpy(np.stack([_local_grid(rng, B, H, W, 2 * H, 2 * W)
                                      for _ in range(g)], axis=3))
    got = dysample_grid_sample_pergroup(x, grid)
    assert got.dtype == dtype and got.shape == (B, 2 * H, 2 * W, C)
    np.testing.assert_array_equal(_np(got),
                                  _np(dysample_grid_sample_ref(x, grid)))
    want = jgs._dysample_ref(jnp.asarray(_np(x)), jnp.asarray(grid.numpy()))
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), **F32)


# --- depthwise 3x3 and its transpose (K13) -----------------------------------

def _dw_inputs(seed, B, H, W, C):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, C)).astype(np.float32),
            (rng.standard_normal((3, 3, 1, C)) * 0.3).astype(np.float32),
            (rng.standard_normal(C) * 0.1).astype(np.float32),
            rng.standard_normal((B, H, W, C)).astype(np.float32))


def _bl(a):
    """NHWC -> the JAX kernel's batch-last (C, H, W, B)."""
    return jnp.asarray(np.transpose(a, (3, 1, 2, 0)))


def _from_bl(a):
    return np.transpose(_np(a), (3, 1, 2, 0))


def _torch_weight(k):
    """flax HWIO (3, 3, 1, C) -> torch (C, 1, 3, 3)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0,
                                                                  1))))


# (B, H, W, C): a ragged 8x8 tile and channel block, a map smaller than one
# tile, and the model's stage-4 geometry at a narrow width
@pytest.mark.parametrize("shape", [(2, 9, 11, 35), (3, 5, 4, 8),
                                   (2, 7, 7, 16)])
@pytest.mark.parametrize("strided", [False, True])
def test_dwconv3x3_and_grads_match_jax_dwconv_bl(shape, strided):
    """Forward against ``dwconv_bl``; dx (the flip mode), dweight and dbias
    against its ``jax.vjp`` (the flipped-tap kernel and XLA's reductions).
    ``strided`` hands x in as the channel slice of a (B*H*W, 2C) tensor, as
    the quad block does."""
    B, H, W, C = shape
    x, k, b, go = _dw_inputs(C + B, B, H, W, C)
    jy, vjp = jax.vjp(lambda x_, k_, b_: dwconv_bl(x_, k_, b_, H, W),
                      _bl(x), jnp.asarray(k), jnp.asarray(b))
    jdx, jdk, jdb = vjp(_bl(go))
    if strided:
        xz = torch.zeros((B * H * W, 2 * C))
        xz[:, :C] = torch.from_numpy(x).reshape(-1, C)
        tx = xz.requires_grad_()[:, :C].view(B, H, W, C)
        assert tx.stride() == (H * W * 2 * C, W * 2 * C, 2 * C, 1)
    else:
        tx = torch.from_numpy(x).requires_grad_()
    tw = _torch_weight(k).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y = dwconv3x3(tx, tw, tb)
    np.testing.assert_allclose(_np(y), _from_bl(jy), **F32)
    y.backward(torch.from_numpy(go))
    dx = xz.grad[:, :C].reshape(B, H, W, C) if strided else tx.grad
    for got, want in ((dx, _from_bl(jdx)),
                      (tw.grad, np.transpose(_np(jdk), (3, 2, 0, 1))),
                      (tb.grad, _np(jdb))):
        np.testing.assert_allclose(_np(got), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_dwconv3x3_flip_is_the_adjoint():
    """<dwconv(x) - bias, g> == <x, flip(g)>: flip mode is the exact
    transpose of the forward; and it equals the JAX kernel's own flip."""
    from ceigm_unet_tpu.ops.quad_scan_bl import _dw_consts, _dwconv_bl_kernel
    B, H, W, C = 2, 6, 5, 7
    x, k, b, g = _dw_inputs(3, B, H, W, C)
    tw = _torch_weight(k)
    y = dwconv3x3(torch.from_numpy(x), tw, torch.zeros(C))
    fg = dwconv3x3_flip(torch.from_numpy(g), tw)
    lhs = float((y.double() * torch.from_numpy(g).double()).sum())
    rhs = float((torch.from_numpy(x).double() * fg.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    wb, bb = _dw_consts(jnp.asarray(k), jnp.zeros((C,)), C, B)
    want = _dwconv_bl_kernel(_bl(g), wb, bb, H, W, flip=True, interpret=True)
    np.testing.assert_allclose(_np(fg), _from_bl(want), **F32)


def test_dwconv3x3_bf16_writes_bf16_from_fp32_sums():
    x, k, b, _ = _dw_inputs(4, 2, 5, 6, 8)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = dwconv3x3(xb, _torch_weight(k), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    want = dwconv3x3_ref(xb.float(), _torch_weight(k), torch.from_numpy(b))
    np.testing.assert_array_equal(_np(got), _np(want.to(torch.bfloat16)))


# --- int8 quad scan (K14) ----------------------------------------------------

def _q8_inputs(seed, B, H, W, D):
    rng = np.random.default_rng(seed)
    K, L = 4, H * W
    u = rng.standard_normal((B, L, K, D)).astype(np.float32)
    dt = (rng.standard_normal((B, L, K, D)) * 0.5).astype(np.float32)
    uq, su = q8(torch.from_numpy(u))
    dq, sdt = q8(torch.from_numpy(dt))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(uq=uq.permute(0, 2, 1, 3), dq=dq.permute(0, 2, 1, 3), su=su,
                sdt=sdt, Bs=torch.from_numpy(f(B, K, L)),
                Cs=torch.from_numpy(f(B, K, L)),
                A=torch.from_numpy(-np.exp(f(K, D) * 0.5)),
                bias=torch.from_numpy(f(K, D) * 0.3),
                Dv=torch.from_numpy(f(K, D)),
                lns=torch.from_numpy(1 + f(K, D) * 0.1),
                lnb=torch.from_numpy(f(K, D) * 0.1))


ORDER = ("uq", "dq", "su", "sdt", "Bs", "Cs", "A", "bias", "Dv", "lns", "lnb")


@pytest.mark.parametrize("shape,dirs", [((2, 6, 10, 8), (1, 2, 3, 4)),
                                        ((2, 7, 7, 12), (4, 1, 3, 2))])
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_quad_scan_ln_cat_q8_matches_jax(shape, dirs, bc_dtype):
    B, H, W, D = shape
    a = _q8_inputs(D, B, H, W, D)
    a["Bs"], a["Cs"] = a["Bs"].to(bc_dtype), a["Cs"].to(bc_dtype)
    got = quad_scan_ln_cat_q8(*[a[k] for k in ORDER], H, W, dirs)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H * W, 4 * D)
    j = {k: jnp.asarray(_np(v)) for k, v in a.items()}
    j["uq"], j["dq"] = (jnp.asarray(a[k].numpy()) for k in ("uq", "dq"))
    j["Bs"], j["Cs"] = (jnp.asarray(_np(a[k]), jnp.bfloat16) if bc_dtype ==
                        torch.bfloat16 else j[k] for k in ("Bs", "Cs"))
    want = jquad_scan.sscan_quad_ln_cat_q8(
        *[j[k] for k in ORDER[:9]], (j["lns"], j["lnb"]), H, W, dirs)
    assert want.dtype == jnp.bfloat16
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-2,
                               atol=1e-2 * np.abs(want).max())


def test_q8_matches_the_jax_formula_and_rounds_half_to_even():
    rng = np.random.default_rng(5)
    t = rng.standard_normal((2, 12, 4, 6)).astype(np.float32)
    q, s = q8(torch.from_numpy(t))
    amax = np.abs(t).max(axis=(0, 1))
    scale = np.maximum(amax, np.float32(1e-6)) / np.float32(127.0)
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(t) / scale), -127,
                               127).astype(jnp.int8))
    assert q.dtype == torch.int8 and s.shape == (4, 6)
    np.testing.assert_array_equal(s.numpy(), scale)
    np.testing.assert_array_equal(q.numpy(), want)
    ties = q8(torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0]).reshape(1, 5, 1, 1))
    assert ties[0].flatten().tolist() == [0, 2, 2, 0, 127]


def test_quad_group_ss2d_quant_matches_jax(monkeypatch):
    """QuadGroupSS2D(quant_scan=True) against the JAX module under
    CEIGM_QUANT=1 on its Pallas route (tests/test_quad_path.py's setup,
    B 2): the int8 u and dt handed to the two scans (at most 0.1% of the
    elements one step apart, none further), and the outputs within 1e-2 *
    max|JAX output| (bf16 scan output)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, 10, 32)).astype(np.float32)
    jm = JQuadGroupSS2D(dim=32, scan_backend="pallas")
    v = _init(jm, 0, jnp.asarray(x))
    seen = {}
    jq8 = jquad_scan.sscan_quad_ln_cat_q8

    def j_capture(u_q, dt_q, *rest):
        jax.debug.callback(lambda a, b: seen.update(j=(np.asarray(a),
                                                       np.asarray(b))),
                           u_q, dt_q)
        return jq8(u_q, dt_q, *rest)

    monkeypatch.setattr(jquad_scan, "sscan_quad_ln_cat_q8", j_capture)
    monkeypatch.setenv("CEIGM_QUANT", "1")
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tq8 = tss2d.quad_scan_ln_cat_q8

    def t_capture(u_q, dt_q, *rest):
        seen["t"] = (u_q.numpy(), dt_q.numpy())
        return tq8(u_q, dt_q, *rest)

    monkeypatch.setattr(tss2d, "quad_scan_ln_cat_q8", t_capture)
    m = _port(QuadGroupSS2D(32, quant_scan=True),
              jax_import.quad_ss2d(v["params"]))
    with torch.no_grad():
        got = m(_t(x)).numpy()
    for jv, tv in zip(seen["j"], seen["t"]):
        diff = np.abs(jv.astype(np.int32) - tv.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def test_quant_scan_refuses_autograd():
    m = QuadGroupSS2D(16, quant_scan=True)
    x = torch.randn((1, 4, 6, 16), generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="inference-only"):
        m(x)
    with torch.no_grad():
        assert m(x).shape == x.shape
    a = _q8_inputs(0, 1, 2, 3, 4)
    a["A"].requires_grad_()
    with pytest.raises(NotImplementedError, match="inference-only"):
        quad_scan_ln_cat_q8(*[a[k] for k in ORDER], 2, 3, (1, 2, 3, 4))


def test_entry_models_run_with_grad_mode_on():
    """entry(quant_scan=True) hands back a model whose parameters do not
    require grad, so ``m(x)`` runs as returned, with grad mode on, while the
    int8 op still refuses inputs that require grad; legacy_entry's model
    runs the same way (its scan ops have a backward)."""
    from ceigm_unet_tpu_torch.entry import entry, legacy_entry
    assert torch.is_grad_enabled()
    m, x = entry(device="cpu", quant_scan=True)
    assert not any(p.requires_grad for p in m.parameters())
    out = m(x)
    assert out.shape == (1, 224, 224, 9) and bool(torch.isfinite(out).all())
    a = _q8_inputs(1, 1, 2, 3, 4)
    a["su"].requires_grad_()
    with pytest.raises(NotImplementedError, match="inference-only"):
        quad_scan_ln_cat_q8(*[a[k] for k in ORDER], 2, 3, (1, 2, 3, 4))
    m, x = legacy_entry(device="cpu")
    out = m(x)
    assert out.shape == (1, 224, 224, 9) and out.requires_grad


# --- the routes through the model --------------------------------------------

def test_routes_are_build_arguments_with_the_jax_defaults():
    m = build_model(enc_name="gm_test", device="cpu")
    blk = m.encoder.gm_encoder.block1[0].attn
    assert (blk.quant_scan, blk.dwconv, m.decoder.eucb3.grouped) == (
        False, "library", True)
    m = build_model(enc_name="gm_test", device="cpu", quant_scan=True,
                    dwconv="kernel", dysample_grouped=False)
    layers = [mod for mod in m.modules() if isinstance(mod, QuadGroupSS2D)]
    assert len(layers) == 11
    assert all(mod.quant_scan and mod.dwconv == "kernel" for mod in layers)
    assert not any(m.decoder.get_submodule(f"eucb{i}").grouped
                   for i in (1, 2, 3))
    with pytest.raises(ValueError, match="dwconv"):
        QuadGroupSS2D(16, dwconv="cudnn")


def test_route_ops_refuse_devices_without_kernels():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        grid_sample_bilinear_fused(x, torch.empty((1, 8, 8, 2),
                                                  device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        dwconv3x3(x, torch.empty((8, 1, 3, 3)), torch.empty(8))


@pytest.fixture(scope="module")
def gm_test_jax():
    """The JAX gm_test model at 64x64, B 2 (``assoc`` scan), with perturbed
    BN statistics and biases: variables, input and logits."""
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 1)).astype(
        np.float32)
    jm = jbuild_model(enc_name="gm_test", scan_backend="assoc")
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(6)
    v = {k: _perturb(t, rng) for k, t in _numpy_tree(v).items()}
    logits = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    return dict(x=x, logits=logits, sd=jax_import.state_dict_from_jax(
        v, depths=GM_TEST_DEPTHS))


def test_kernel_routes_logits_match_jax(gm_test_jax):
    """gm_test with dwconv="kernel", dysample_grouped=False loads the same
    converted weights as the default route and gives the JAX logits at
    tests/test_torch_model.py's tolerance."""
    model = build_model(enc_name="gm_test", device="cpu", dwconv="kernel",
                        dysample_grouped=False)
    jax_import.load_numpy_state_dict(model, gm_test_jax["sd"])
    with torch.no_grad():
        got = model(_t(gm_test_jax["x"]))
    np.testing.assert_allclose(got.numpy(), gm_test_jax["logits"],
                               **LOGITS_TOL)


def test_quant_route_logits_close_to_jax(gm_test_jax):
    """gm_test with quant_scan=True loads the same weights; int8 storage
    moves the logits by well under 0.05 * max|logit| (the bf16 bound)."""
    model = build_model(enc_name="gm_test", device="cpu", quant_scan=True)
    jax_import.load_numpy_state_dict(model, gm_test_jax["sd"])
    with torch.no_grad():
        got = model(_t(gm_test_jax["x"])).numpy()
    want = gm_test_jax["logits"]
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()
