"""Port ops (``ceigm_unet_tpu_torch.ops``) against the JAX package's entry
points, on the CPU: each kernel op's plain PyTorch version against the JAX
function, which runs its Pallas kernel in interpret mode here. Inputs are
made with numpy from a seed and handed to both. The hand-written kernels
themselves are held against these plain versions on a card by
tests/test_torch_cuda.py.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceigm_unet_tpu.ops import grid_sample as jgs
from ceigm_unet_tpu.ops.activations import gelu as jgelu
from ceigm_unet_tpu.ops.ffn_pallas import (_cffn_ref, custom_ffn_fused as
                                           jcffn, inception_composite as
                                           jcomposite)
from ceigm_unet_tpu.ops.quad_scan import sscan_quad_ln_cat
from ceigm_unet_tpu.ops.resize import (zoom_slices as jzoom,
                                       zoom_slices_nearest as jzoom_nearest)
from ceigm_unet_tpu.ops.tapconv import lgag_gate_eval as jlgag
from ceigm_unet_tpu_torch.ops import _build
from ceigm_unet_tpu_torch.ops.activations import gelu
from ceigm_unet_tpu_torch.ops.ffn import (custom_ffn_fused,
                                          dw3_gelu_inception7, ffn_gemm,
                                          ffn_gemm_ref, gemm_operands,
                                          inception_composite)
from ceigm_unet_tpu_torch.ops.grid_sample import (dysample_grid_sample,
                                                  grid_sample_bilinear)
from ceigm_unet_tpu_torch.ops.quad_scan import (quad_scan_ln_cat,
                                                quad_scan_ln_cat_ref, scan2d,
                                                scan2d_adjoint,
                                                scan2d_adjoint_ref,
                                                scan2d_ref)
from ceigm_unet_tpu_torch.ops.resize import zoom_slices, zoom_slices_nearest
from ceigm_unet_tpu_torch.ops.tapconv import lgag_gate, lgag_gate_eval

torch.set_num_threads(1)

# fp32: the scan/FFN/LGAG kernels' own test tolerances; bf16: the reference
# kernel suite's bf16 row (tests/test_kernel_matrix.py)
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=5e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(a):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, np.float32)


def _both(a, dtype="float32"):
    """numpy -> (jax array, torch tensor) with identical values."""
    j = jnp.asarray(a, JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


# --- quad scan + group LN ----------------------------------------------------

def _quad_inputs(B, H, W, D, seed, long_memory=False):
    """Long memory: A = -exp(-8) and a dt bias near -2 keep each step's
    decay within 2e-4 of 1, so the state carries over the whole walk."""
    rng = np.random.default_rng(seed)
    K, L = 4, H * W
    a = dict(
        u=rng.standard_normal((B, K, L, D)),
        dt=rng.standard_normal((B, K, L, D)) * 0.5,
        Bs=rng.standard_normal((B, K, L)),
        Cs=rng.standard_normal((B, K, L)),
        A=-np.exp(rng.standard_normal((K, D)) * 0.5),
        bias=rng.standard_normal((K, D)) * 0.3,
        Dv=rng.standard_normal((K, D)),
        lns=1.0 + rng.standard_normal((K, D)) * 0.1,
        lnb=rng.standard_normal((K, D)) * 0.1)
    if long_memory:
        a["A"] = np.full((K, D), -np.exp(-8.0))
        a["bias"] -= 2.0
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (2, 6, 10, 8), (2, 7, 7, 12),
    pytest.param((1, 16, 16, 8, "long memory"), id="long-memory")])
def test_quad_scan_ln_cat_matches_jax(shape, dtype):
    B, H, W, D, *long_memory = shape
    a = _quad_inputs(B, H, W, D, seed=D, long_memory=bool(long_memory))
    act = {k: _both(a[k], dtype) for k in ("u", "dt", "Bs", "Cs")}
    prm = {k: _both(a[k]) for k in ("A", "bias", "Dv", "lns", "lnb")}
    dirs = (1, 2, 3, 4)
    want = sscan_quad_ln_cat(
        *[act[k][0] for k in ("u", "dt", "Bs", "Cs")],
        *[prm[k][0] for k in ("A", "bias", "Dv")],
        (prm["lns"][0], prm["lnb"][0]), H, W, dirs)
    got = quad_scan_ln_cat(*[act[k][1] for k in ("u", "dt", "Bs", "Cs")],
                           *[prm[k][1] for k in ("A", "bias", "Dv", "lns",
                                                 "lnb")], H, W, dirs)
    assert got.dtype == TDT[dtype] and got.shape == (B, H * W, 4 * D)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def test_quad_scan_direction_order_and_strides():
    """Permuted directions and a strided (B, L, K, D) view give the same
    result as contiguous inputs scanned group by group."""
    B, H, W, D = 2, 5, 6, 4
    a = _quad_inputs(B, H, W, D, seed=3)
    t = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in a.items()}
    dirs = (3, 1, 4, 2)
    ref = quad_scan_ln_cat_ref(t["u"], t["dt"], t["Bs"], t["Cs"], t["A"],
                               t["bias"], t["Dv"], t["lns"], t["lnb"], H, W,
                               dirs)
    u_blkd = t["u"].permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    got = quad_scan_ln_cat(u_blkd, t["dt"], t["Bs"], t["Cs"], t["A"],
                           t["bias"], t["Dv"], t["lns"], t["lnb"], H, W, dirs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=0)
    for k, d in enumerate(dirs):
        one = quad_scan_ln_cat_ref(
            *[t[n][:, k:k + 1] for n in ("u", "dt", "Bs", "Cs")],
            *[t[n][k:k + 1] for n in ("A", "bias", "Dv", "lns", "lnb")],
            H, W, (d,))
        np.testing.assert_allclose(got[..., k * D:(k + 1) * D].numpy(),
                                   one.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("adjoint", [False, True])
def test_scan2d_takes_the_backward_layouts(adjoint):
    """K8's wrapper on CPU tensors in the layouts the backward hands it
    (the quad scan's (B, L, K, D) storage, the legacy scan's decay in
    (K, B, L, D) beside a (B, L, K, D) drive, stride-0 views over K) equals
    the plain version on contiguous copies. An operand without unit stride
    over D, which the kernel cannot take, raises, on the CPU as on a card,
    instead of being copied."""
    rng = np.random.default_rng(5)
    B, K, H, W, D = 2, 4, 5, 6, 8
    L = H * W
    a = torch.sigmoid(torch.from_numpy(
        rng.standard_normal((B, K, L, D)).astype(np.float32)) * 2 + 2)
    b = torch.from_numpy(rng.standard_normal((B, K, L, D)).astype(np.float32))
    fn, ref = ((scan2d_adjoint, scan2d_adjoint_ref) if adjoint
               else (scan2d, scan2d_ref))
    dirs = (3, 1, 4, 2)
    lay = lambda t, o: t.permute(o).contiguous().permute(o)
    cases = [(lay(a, (0, 2, 1, 3)), lay(b, (0, 2, 1, 3))),
             (lay(a, (1, 0, 2, 3)), lay(b, (0, 2, 1, 3))),
             (a[:, :1].expand(B, K, L, D), b[:, :1].expand(B, K, L, D))]
    for am, bm in cases:
        assert not am.is_contiguous() and not bm.is_contiguous()
        got = fn(am, bm, H, W, dirs)
        assert got.is_contiguous()
        np.testing.assert_allclose(
            got.numpy(), ref(am.contiguous(), bm.contiguous(), H, W,
                             dirs).numpy(), rtol=1e-6, atol=1e-6)
    bad = b.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="unit stride over D"):
        fn(a, bad, H, W, dirs)
    with pytest.raises(ValueError, match="unit stride over D"):
        fn(bad, b, H, W, dirs)


# --- CustomFfn -----------------------------------------------------------------

def _cffn_inputs(H, W, C, HID, seed):
    rng = np.random.default_rng(seed)
    g = HID // 8
    return dict(
        x=rng.standard_normal((1, H * W, C)),
        w1=rng.standard_normal((C, HID)) * 0.05,
        b1=rng.standard_normal(HID) * 0.1,
        dwk=rng.standard_normal((3, 3, 1, HID)) * 0.2,
        dwb=rng.standard_normal(HID) * 0.1,
        p3k=rng.standard_normal((3, 3, 1, g)) * 0.2,
        p5k=rng.standard_normal((5, 5, 1, g)) * 0.1,
        p7k=rng.standard_normal((7, 7, 1, g)) * 0.05,
        p3b=rng.standard_normal(g) * 0.1, p5b=rng.standard_normal(g) * 0.1,
        p7b=rng.standard_normal(g) * 0.1,
        w2=rng.standard_normal((HID, C)) * 0.05,
        b2=rng.standard_normal(C) * 0.1)


def test_inception_composite_matches_jax():
    a = _cffn_inputs(4, 4, 8, 64, seed=1)
    names = ("p3k", "p5k", "p7k", "p3b", "p5b", "p7b")
    jk, jb = jcomposite(64, 8, *[_both(a[n])[0] for n in names], jnp.float32)
    tk, tb = inception_composite(64, 8, *[_both(a[n])[1] for n in names],
                                 torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("HWC", [(8, 10, 16, 32), (14, 14, 32, 64)])
def test_custom_ffn_matches_jax(HWC, dtype):
    H, W, C, HID = HWC
    a = _cffn_inputs(H, W, C, HID, seed=C)
    comp = ("p3k", "p5k", "p7k", "p3b", "p5b", "p7b")
    jinck, jincb = jcomposite(HID, HID // 8, *[_both(a[n])[0] for n in comp],
                              jnp.float32)
    tinck, tincb = inception_composite(HID, HID // 8,
                                       *[_both(a[n])[1] for n in comp],
                                       torch.float32)
    cast = {n: _both(a[n], dtype if n in ("x", "w1", "w2") else "float32")
            for n in ("x", "w1", "b1", "dwk", "dwb", "w2", "b2")}
    jargs = [cast["x"][0], cast["w1"][0], cast["b1"][0], cast["dwk"][0],
             cast["dwb"][0], jinck, jincb, cast["w2"][0], cast["b2"][0]]
    targs = [cast["x"][1], cast["w1"][1], cast["b1"][1], cast["dwk"][1],
             cast["dwb"][1], tinck, tincb, cast["w2"][1], cast["b2"][1]]
    n_tap = 3 * (HID // 8)
    got = custom_ffn_fused(*targs, H, W, n_tap)
    assert got.dtype == TDT[dtype]
    for want in (jcffn(*jargs, H, W, n_tap), _cffn_ref(*jargs, H, W)):
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def test_ffn_stages_compose_to_custom_ffn():
    """fc1 GEMM -> dw3x3+GELU+inception -> fc2 GEMM, the stages the card
    runs as separate kernels, equal the plain CustomFfn in fp32."""
    H, W, C, HID = 6, 7, 16, 64
    a = {k: torch.from_numpy(np.asarray(v, np.float32))
         for k, v in _cffn_inputs(H, W, C, HID, seed=2).items()}
    inck, incb = inception_composite(HID, HID // 8, a["p3k"], a["p5k"],
                                     a["p7k"], a["p3b"], a["p5b"], a["p7b"],
                                     torch.float32)
    h = ffn_gemm(a["x"].reshape(H * W, C), a["w1"], a["b1"], torch.float32)
    q = dw3_gelu_inception7(h, a["dwk"], a["dwb"], inck, incb, H, W,
                            HID - 3 * (HID // 8))
    got = ffn_gemm(q, a["w2"], a["b2"], torch.float32)
    want = custom_ffn_fused(a["x"], a["w1"], a["b1"], a["dwk"], a["dwb"],
                            inck, incb, a["w2"], a["b2"], H, W)
    np.testing.assert_allclose(got.numpy(), want.reshape(H * W, C).numpy(),
                               rtol=1e-5, atol=1e-5)


# 6x7, and 3x9: every pixel within the 7x7's reach of the border
@pytest.mark.parametrize("HW", [(6, 7), (3, 9)])
def test_dw3_gelu_inception7_matches_jax_hidden_path(HW):
    """The stencil between the GEMMs against the JAX CustomFfn's hidden
    path: with w1 and w2 the identity (C = HID) and b1, b2 zero, JAX's
    ``custom_ffn_fused`` (its Pallas kernel in interpret mode) computes
    exactly q + composite7x7(q) + incb with q = gelu(dw3(x) + dwb). dwb of
    scale 1 makes a border q computed as gelu(dwb), where the 7x7's
    padding has 0, show far above the tolerance."""
    H, W = HW
    HID = 64
    a = _cffn_inputs(H, W, HID, HID, seed=3)
    a["dwb"] = a["dwb"] * 10.0
    comp = ("p3k", "p5k", "p7k", "p3b", "p5b", "p7b")
    jinck, jincb = jcomposite(HID, HID // 8, *[_both(a[n])[0] for n in comp],
                              jnp.float32)
    tinck, tincb = inception_composite(HID, HID // 8,
                                       *[_both(a[n])[1] for n in comp],
                                       torch.float32)
    (jx, tx), (jdwk, tdwk), (jdwb, tdwb) = [_both(a[n])
                                            for n in ("x", "dwk", "dwb")]
    eye, zero = np.eye(HID), np.zeros(HID)
    n_tap = 3 * (HID // 8)
    want = jcffn(jx, _both(eye)[0], _both(zero)[0], jdwk, jdwb, jinck, jincb,
                 _both(eye)[0], _both(zero)[0], H, W, n_tap)
    got = dw3_gelu_inception7(tx.reshape(H * W, HID), tdwk, tdwb, tinck,
                              tincb, H, W, HID - n_tap)
    np.testing.assert_allclose(_f32(got), _f32(want).reshape(H * W, HID),
                               **TOL["float32"])


@pytest.mark.parametrize("fc2", [False, True])
def test_gemm_operands_pad_k_for_tma(fc2):
    """The bf16-weight kernel's operands at K = 348 (fc1 at 14x14): both
    padded with zero columns to K 352 (16-byte rows for its TMA loads), W as
    nn.Linear's (N, K) rows, and the padded pair's product equals
    ffn_gemm_ref's; a pair that already fits passes without a copy, and a
    transposed weight comes back as (N, K) rows."""
    rng = np.random.default_rng(7)
    M, K, N = 392, 348, 96
    a = torch.from_numpy(rng.standard_normal((M, K), np.float32))
    a = a if fc2 else a.bfloat16()
    w = torch.from_numpy(rng.standard_normal((N, K), np.float32)
                         * 0.05).bfloat16()
    bias = torch.from_numpy(rng.standard_normal(N, np.float32))
    od = torch.bfloat16 if fc2 else torch.float32
    ap, wp = gemm_operands(a, w.t())
    assert ap.shape == (M, 352) and wp.shape == (N, 352)
    assert ap.is_contiguous() and wp.is_contiguous()
    assert not ap[:, K:].any() and not wp[:, K:].any()
    tol = 1e-2 if fc2 else 1e-5
    torch.testing.assert_close(ffn_gemm_ref(ap, wp.t(), bias, od),
                               ffn_gemm_ref(a, w.t(), bias, od), rtol=tol,
                               atol=tol)
    a2, w2 = gemm_operands(ap, wp.t())
    assert a2.data_ptr() == ap.data_ptr() and w2.data_ptr() == wp.data_ptr()
    _, w3 = gemm_operands(ap, wp.t().contiguous())
    assert w3.is_contiguous() and torch.equal(w3, wp)


def test_gemm_operands_fp32_pass_linear_weight_storage():
    """The fp32 route's operands at CustomFfn's fp32 shapes: nn.Linear's
    (N, K) weight, passed as ``fc.weight.t()``, and a contiguous x come back
    as the same storage (same data_ptr): a forward copies no weight."""
    for K, N in ((348, 1392), (1392, 348), (64, 256), (256, 64)):
        fc = torch.nn.Linear(K, N)
        a = torch.randn((50, K))
        ac, wc = gemm_operands(a, fc.weight.t())
        assert ac.data_ptr() == a.data_ptr()
        assert wc.data_ptr() == fc.weight.data_ptr()
        assert wc.shape == (N, K)


@pytest.mark.parametrize("layout", ["strided", "misaligned", "kn_weight"])
def test_gemm_operands_fp32_copy_what_float4_loads_cannot_take(layout):
    """A non-contiguous operand, one whose base is one element off 16
    bytes, and a weight stored (K, N) are copied into contiguous, 16-byte
    aligned (M, K) / (N, K) storage with the same values."""
    rng = np.random.default_rng(11)
    M, K, N = 40, 348, 87
    a = torch.from_numpy(rng.standard_normal((M, 2 * K), np.float32))
    w = torch.from_numpy(rng.standard_normal((N, K), np.float32))
    if layout == "strided":
        a_in, w_in = a[:, ::2], w.t()
    elif layout == "misaligned":
        a_in = a.reshape(-1)[1:M * K + 1].view(M, K)
        w_in = torch.empty(N * K + 1)[1:].view(N, K).copy_(w).t()
    else:
        a_in, w_in = a[:, :K].contiguous(), w.t().contiguous()
    assert not (a_in.is_contiguous() and a_in.data_ptr() % 16 == 0
                and w_in.t().is_contiguous() and w_in.data_ptr() % 16 == 0)
    ac, wc = gemm_operands(a_in, w_in)
    for got, want in ((ac, a_in), (wc, w_in.t())):
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, want)


@pytest.mark.parametrize("K", [345, 1, 4, 347])
def test_gemm_operands_fp32_pad_k_to_whole_float4s(K):
    """K not a multiple of 4 is padded with zero columns to the next one
    (the fp32 kernel loads float4s along K), and ffn_gemm_ref on the
    padded operands equals ffn_gemm_ref on the inputs."""
    rng = np.random.default_rng(K)
    M, N = 30, 87
    a = torch.from_numpy(rng.standard_normal((M, K), np.float32))
    w = torch.from_numpy(rng.standard_normal((N, K), np.float32) * 0.05)
    bias = torch.from_numpy(rng.standard_normal(N, np.float32))
    ac, wc = gemm_operands(a, w.t())
    Kp = -(-K // 4) * 4
    assert ac.shape == (M, Kp) and wc.shape == (N, Kp)
    assert not ac[:, K:].any() and not wc[:, K:].any()
    assert torch.equal(ac[:, :K], a) and torch.equal(wc[:, :K], w)
    torch.testing.assert_close(
        ffn_gemm_ref(ac, wc.t(), bias, torch.float32),
        ffn_gemm_ref(a, w.t(), bias, torch.float32), rtol=1e-6, atol=1e-6)


# --- DySample grouped grid-sample ---------------------------------------------

def _dysample_grid(rng, B, H, W, g, offset_std):
    """DySample-like grid (B, 2H, 2W, g, 2): base i + sin(pi(i+1)/S), the
    +-0.25 subpixel positions, and learned offsets of ``offset_std`` px."""
    def axis(n):
        base = np.arange(n) + np.sin(np.pi * np.arange(1, n + 1) / n)
        return np.repeat(base, 2) + np.tile([-0.25, 0.25], n)
    cx = axis(W)[None, None, :, None] + rng.standard_normal(
        (B, 2 * H, 2 * W, g)) * offset_std
    cy = axis(H)[None, :, None, None] + rng.standard_normal(
        (B, 2 * H, 2 * W, g)) * offset_std
    return np.stack([2.0 * cx / W - 1.0, 2.0 * cy / H - 1.0], axis=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BHWC", [(2, 7, 7, 16), (2, 14, 14, 32)])
def test_dysample_grid_sample_matches_jax(BHWC, dtype):
    B, H, W, C = BHWC
    rng = np.random.default_rng(C)
    jx, tx = _both(rng.standard_normal((B, H, W, C)), dtype)
    jg, tg = _both(_dysample_grid(rng, B, H, W, 4, 0.1))
    got = dysample_grid_sample(tx, tg)
    assert got.dtype == TDT[dtype] and got.shape == (B, 2 * H, 2 * W, C)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else TOL[dtype]
    for want in (jgs._gs_banded_groups_impl(jx, jg, interpret=True),
                 jgs._dysample_ref(jx, jg)):
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_grid_sample_bilinear_border_clamp_matches_jax():
    rng = np.random.default_rng(4)
    jx, tx = _both(rng.standard_normal((2, 5, 7, 3)))
    jg, tg = _both(rng.uniform(-1.4, 1.4, (2, 9, 6, 2)))
    np.testing.assert_allclose(grid_sample_bilinear(tx, tg).numpy(),
                               np.asarray(jgs.grid_sample_bilinear(jx, jg)),
                               rtol=1e-5, atol=1e-5)


# --- LGAG gate -------------------------------------------------------------------

def _lgag_inputs(C, seed):
    rng = np.random.default_rng(seed)
    C2 = C // 2
    convs = [(rng.standard_normal((k, k, 2, C2)) * 0.2,
              rng.standard_normal(C2) * 0.1) for k in (1, 3, 5, 1, 3, 5)]
    bn = lambda n: dict(scale=1 + rng.standard_normal(n) * 0.1,
                        bias=rng.standard_normal(n) * 0.1,
                        mean=rng.standard_normal(n) * 0.1,
                        var=1 + rng.random(n) * 0.3)
    return dict(convs=convs, bn=bn(C2), psi_w=rng.standard_normal(
        (1, 1, C2, 1)) * 0.3, psi_b=rng.standard_normal(1) * 0.1,
        psi_bn=bn(1), g=rng.standard_normal((2, 6, 9, C)),
        x=rng.standard_normal((2, 6, 9, C)))


def _lgag_args(a, i, dtype="float32"):
    """Argument list of lgag_gate_eval for framework i (0 jax, 1 torch)."""
    c = lambda v, dt="float32": _both(v, dt)[i]
    return [c(a["g"], dtype), c(a["x"], dtype),
            [(c(k), c(b)) for k, b in a["convs"]],
            {n: c(v) for n, v in a["bn"].items()}, c(a["psi_w"]),
            c(a["psi_b"]), {n: c(v) for n, v in a["psi_bn"].items()}]


@pytest.mark.parametrize("C", [16, 24])
def test_lgag_gate_eval_matches_jax(C):
    a = _lgag_inputs(C, seed=C)
    want = jlgag(*_lgag_args(a, 0))
    got = lgag_gate_eval(*_lgag_args(a, 1))
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=2e-5,
                               atol=2e-5)


def test_lgag_gate_eval_bf16_matches_jax():
    a = _lgag_inputs(16, seed=5)
    want = jlgag(*_lgag_args(a, 0, "bfloat16"))
    got = lgag_gate_eval(*_lgag_args(a, 1, "bfloat16"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["bfloat16"])


# --- GELU and zoom ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax(dtype):
    x = np.linspace(-6.0, 6.0, 4001)
    jx, tx = _both(x, dtype)
    got = gelu(tx)
    assert got.dtype == TDT[dtype]
    # bf16: both evaluate the polynomial in bf16; rounding points differ
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(_f32(got), _f32(jgelu(jx)), **tol)


@pytest.mark.parametrize("shape,out", [((2, 30, 40), (64, 48)),
                                       ((3, 80, 80), (64, 64))])
def test_zoom_slices_match_jax(shape, out):
    rng = np.random.default_rng(0)
    v = rng.random(shape).astype(np.float32)
    np.testing.assert_allclose(zoom_slices(torch.from_numpy(v), out).numpy(),
                               np.asarray(jzoom(jnp.asarray(v), out)),
                               rtol=1e-5, atol=1e-5)
    lab = rng.integers(0, 9, shape).astype(np.int64)
    np.testing.assert_array_equal(
        zoom_slices_nearest(torch.from_numpy(lab), out).numpy(),
        np.asarray(jzoom_nearest(jnp.asarray(lab), out)))


# --- dispatch and packaging -------------------------------------------------------

def test_wrappers_refuse_devices_without_kernels():
    """A tensor that is neither on the CPU nor on a CUDA card raises: the
    plain version runs only for CPU tensors."""
    x = torch.empty((1, 4, 4, 8), device="meta")
    grid = torch.empty((1, 8, 8, 4, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dysample_grid_sample(x, grid)
    with pytest.raises(ValueError, match="no kernel"):
        lgag_gate(x, x, torch.empty((5, 5, 2, 4)), *[torch.empty(4)] * 3,
                  torch.empty(3))
    with pytest.raises(ValueError, match="no kernel"):
        dw3_gelu_inception7(torch.empty((16, 8), device="meta"),
                            torch.empty((3, 3, 1, 8)), torch.empty(8),
                            torch.empty((7, 7, 1, 8)), torch.empty(8), 4, 4)


def test_ffn_gemm_rejects_dtype_pairs_the_kernel_lacks():
    a = torch.zeros((4, 8), dtype=torch.bfloat16)
    w = torch.zeros((8, 2), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        ffn_gemm(a, w, torch.zeros(2), torch.bfloat16)


def test_build_sources_and_hash():
    names = sorted(p.name for p in _build.sources())
    assert names == ["cffn.cu", "cffn_gemm.cu", "common.cuh", "dwconv3.cu",
                     "grid_sample.cu", "lgag.cu", "quad_scan_ln.cu",
                     "scan2d.cu", "scan_rows.cu", "sscan_dir.cu"]
    assert _build.source_hash() == _build.source_hash()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_port_imports_no_jax():
    code = ("import sys, ceigm_unet_tpu_torch, ceigm_unet_tpu_torch.models, "
            "ceigm_unet_tpu_torch.eval.volume, ceigm_unet_tpu_torch.entry, "
            "ceigm_unet_tpu_torch.convert.jax_import, "
            "ceigm_unet_tpu_torch.losses, ceigm_unet_tpu_torch.train, "
            "ceigm_unet_tpu_torch.train.config, "
            "ceigm_unet_tpu_torch.train.lr_scheduler, "
            "ceigm_unet_tpu_torch.train.trainstep, "
            "ceigm_unet_tpu_torch.models.vmamba, "
            "ceigm_unet_tpu_torch.ops.cross_scan, "
            "ceigm_unet_tpu_torch.ops.selective_scan, "
            "ceigm_unet_tpu_torch.ops.dwconv, "
            "ceigm_unet_tpu_torch.kernel_ab, "
            "ceigm_unet_tpu_torch.eval.metrics, "
            "ceigm_unet_tpu_torch.eval.plot, "
            "ceigm_unet_tpu_torch.data.datasets, "
            "ceigm_unet_tpu_torch.convert.checkpoint, "
            "ceigm_unet_tpu_torch.train.loop, "
            "ceigm_unet_tpu_torch.cli.inference, "
            "ceigm_unet_tpu_torch.cli.calc_params, "
            "ceigm_unet_tpu_torch.native, "
            "ceigm_unet_tpu_torch.data.augment, "
            "ceigm_unet_tpu_torch.data.loader, "
            "ceigm_unet_tpu_torch.data.device_aug, "
            "ceigm_unet_tpu_torch.convert.torch_import, "
            "ceigm_unet_tpu_torch.cli.train_synapse, "
            "ceigm_unet_tpu_torch.cli.train_acdc, "
            "ceigm_unet_tpu_torch.parallel, "
            "ceigm_unet_tpu_torch.parallel.mesh, "
            "ceigm_unet_tpu_torch.parallel.ring_scan, "
            "ceigm_unet_tpu_torch.parallel.dryrun, "
            "ceigm_unet_tpu_torch.utils, "
            "ceigm_unet_tpu_torch.utils.debug, "
            "ceigm_unet_tpu_torch.convert.vssm_import; "
            "from ceigm_unet_tpu_torch.entry import legacy_entry, train_entry; "
            "from ceigm_unet_tpu_torch.entry import legacy_train_entry; "
            "from ceigm_unet_tpu_torch.ops.grid_sample import "
            "grid_sample_bilinear_fused, dysample_grid_sample_pergroup; "
            "from ceigm_unet_tpu_torch.ops.quad_scan import "
            "quad_scan_ln_cat_q8; "
            "from ceigm_unet_tpu_torch.entry import entry; "
            "entry('cpu', quant_scan=True, dwconv='kernel', "
            "dysample_grouped=False); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ceigm_unet_tpu') "
            "or m.startswith('ceigm_unet_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
