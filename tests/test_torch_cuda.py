"""The hand-written Hopper kernels against their plain PyTorch versions, on
an NVIDIA card. Every test is marked ``cuda`` and skips without a card.
This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 with TF32 off, rtol 1e-4 and atol 1e-4 * max|plain| (the
kernels sum in another order than the plain versions); bf16 rtol 3e-2 and
atol 5e-2 * max|plain| (tests/test_kernel_matrix.py's bf16 row).
Gradients on the card against the CPU: rtol 2e-3 and atol 1e-8 + 2e-3 *
max|CPU grad| per tensor (tests/test_torch_grad_parity.py's comparison).
"""
import math
import re

import numpy as np
import pytest
import torch

from ceigm_unet_tpu_torch.eval import volume as served
from ceigm_unet_tpu_torch.models import build_legacy_model, build_model
from ceigm_unet_tpu_torch.models.ss2d import q8
from ceigm_unet_tpu_torch.ops import _build
from ceigm_unet_tpu_torch.ops.dwconv import (dwconv3x3, dwconv3x3_flip,
                                             dwconv3x3_ref)
from ceigm_unet_tpu_torch.ops.ffn import (custom_ffn_fused,
                                          custom_ffn_fused_ref,
                                          dw3_gelu_inception7,
                                          dw3_gelu_inception7_ref,
                                          inception_composite)
from ceigm_unet_tpu_torch.ops.grid_sample import (dysample_grid_sample,
                                                  dysample_grid_sample_ref,
                                                  grid_sample_bilinear,
                                                  grid_sample_bilinear_fused)
from ceigm_unet_tpu_torch.ops.ffn import ffn_gemm, ffn_gemm_ref
from ceigm_unet_tpu_torch.ops.quad_scan import (quad_scan_ln_cat,
                                                quad_scan_ln_cat_q8,
                                                quad_scan_ln_cat_q8_ref,
                                                quad_scan_ln_cat_ref, scan2d,
                                                scan2d_adjoint,
                                                scan2d_adjoint_ref,
                                                scan2d_ref, sscan_dir,
                                                sscan_dir_ref)
from ceigm_unet_tpu_torch.ops.selective_scan import (scan_rows, scan_rows_ref,
                                                     selective_scan,
                                                     selective_scan_n1,
                                                     selective_scan_n1_ref)
from ceigm_unet_tpu_torch.ops.tapconv import lgag_gate, lgag_gate_ref
from ceigm_unet_tpu_torch.train.trainstep import (cosine_lr, make_optimizer,
                                                  make_train_step,
                                                  param_groups)
from ceigm_unet_tpu_torch.utils import spans
from plain_volume import plain_predict_volume

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 5e-2)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    rtol, atol = TOL[dtype]
    want = want.float().cpu()
    got = got.float().cpu()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=atol * max(want.abs().max().item(), 1e-6))


def _rand(gen, shape, dev, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)


def _quad_prm(g, K, D, dev, long_memory=False):
    """A, dt bias, D, LN scale, LN bias of the quad scan. Long memory: A =
    -exp(-8) and a dt bias near -2 keep each step's decay exp(d*A) within
    2e-4 of 1, so the state carries across every chunk of the chain and a
    wrong carry-in shows far above the tolerance."""
    A = (torch.full((K, D), -math.exp(-8.0), device=dev) if long_memory
         else -torch.exp(_rand(g, (K, D), dev, 0.5)))
    return [A, _rand(g, (K, D), dev, .3) - (2.0 if long_memory else 0.0),
            _rand(g, (K, D), dev), 1 + _rand(g, (K, D), dev, .1),
            _rand(g, (K, D), dev, .1)]


# long-memory cases at D 8-128, L not a multiple of a chunk (7x9) and 56x56
LONG_MEMORY = [pytest.param((*s, "long memory"), id="long-memory-{}x{}x{}x{}"
                            .format(*s))
               for s in [(2, 7, 9, 8), (1, 56, 56, 16), (2, 7, 9, 40),
                         (2, 14, 14, 87), (2, 7, 9, 128)]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 56, 56, 16), (2, 14, 14, 87),
                                   (3, 7, 7, 112), (1, 5, 9, 8),
                                   (2, 7, 7, 128), *LONG_MEMORY])
def test_quad_scan_ln_kernel(dev, shape, dtype):
    B, H, W, D, *long_memory = shape
    g = torch.Generator().manual_seed(D)
    L, K = H * W, 4
    act = [_rand(g, (B, K, L, D), dev, s, DT[dtype]) for s in (1.0, 0.5)]
    act += [_rand(g, (B, K, L), dev, 1.0, DT[dtype]) for _ in range(2)]
    prm = _quad_prm(g, K, D, dev, bool(long_memory))
    dirs = (1, 2, 3, 4)
    _close(quad_scan_ln_cat(*act, *prm, H, W, dirs),
           quad_scan_ln_cat_ref(*act, *prm, H, W, dirs), dtype)
    # the model's strided (B, L, K, D) GEMM-output views
    blkd = [a.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
            for a in act[:2]]
    _close(quad_scan_ln_cat(*blkd, *act[2:], *prm, H, W, (4, 3, 2, 1)),
           quad_scan_ln_cat_ref(*act, *prm, H, W, (4, 3, 2, 1)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# L below a chunk (3x4) and 1 (1x1), L not a multiple of one (5x9, 9x7),
# a column walk with H > W (50x3), K < 4, D at every chunk shape (16 lanes;
# 32 lanes with 1, 2, 3 or 4 channels each: D 5, 33, 40, 64, 96, 128);
# 37 x 3 (b, k) chains, whose last wave of blocks is partial; gm_base's 28x28
# D48 and 14x14 D106
@pytest.mark.parametrize("shape,dirs", [
    ((1, 3, 4, 16), (1, 2, 3, 4)), ((2, 1, 1, 5), (1, 2, 3, 4)),
    ((2, 5, 9, 40), (4, 3, 2, 1)), ((1, 50, 3, 33), (2, 4)),
    ((2, 9, 7, 64), (3, 1, 4, 2)), ((37, 14, 14, 96), (2, 4, 1)),
    ((1, 16, 17, 128), (1, 2, 3, 4)), ((2, 28, 28, 48), (1, 2, 3, 4)),
    ((2, 14, 14, 106), (1, 2, 3, 4))])
def test_quad_scan_ln_kernel_edges(dev, shape, dirs, dtype):
    """Model-layout operands: u and dt (B, L, K, D) GEMM outputs and Bs, Cs
    slices of an x_dbl (B, L, K, R + 2), viewed as (B, K, L[, D])."""
    B, H, W, D = shape
    g = torch.Generator().manual_seed(D + H)
    K, L, R = len(dirs), H * W, -(-D // 16)
    u, dt = [_rand(g, (B, L, K, D), dev, s, DT[dtype]).permute(0, 2, 1, 3)
             for s in (1.0, 0.5)]
    x_dbl = _rand(g, (B, L, K, R + 2), dev, 1.0, DT[dtype])
    BC = [x_dbl[..., R + i].permute(0, 2, 1) for i in (0, 1)]
    prm = _quad_prm(g, K, D, dev, long_memory=D % 2 == 0)
    got = quad_scan_ln_cat(u, dt, *BC, *prm, H, W, dirs)
    assert got.dtype == DT[dtype] and got.shape == (B, L, K * D)
    _close(got, quad_scan_ln_cat_ref(u, dt, *BC, *prm, H, W, dirs), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("HWC", [(14, 14, 348, 1392), (8, 10, 16, 32)])
@pytest.mark.parametrize("tap_all", [False, True])
def test_cffn_kernels(dev, HWC, dtype, tap_all):
    H, W, C, HID = HWC
    g = torch.Generator().manual_seed(C)
    gb = HID // 8
    inck, incb = inception_composite(
        HID, gb, _rand(g, (3, 3, 1, gb), dev, .2),
        _rand(g, (5, 5, 1, gb), dev, .1), _rand(g, (7, 7, 1, gb), dev, .05),
        *[_rand(g, (gb,), dev, .1) for _ in range(3)], torch.float32)
    args = [_rand(g, (2, H * W, C), dev, 1.0, DT[dtype]),
            _rand(g, (C, HID), dev, .05, DT[dtype]), _rand(g, (HID,), dev, .1),
            _rand(g, (3, 3, 1, HID), dev, .2), _rand(g, (HID,), dev, .1),
            inck, incb, _rand(g, (HID, C), dev, .05, DT[dtype]),
            _rand(g, (C,), dev, .1)]
    n_tap = 0 if tap_all else 3 * gb
    _close(custom_ffn_fused(*args, H, W, n_tap),
           custom_ffn_fused_ref(*args, H, W, n_tap), dtype)


@pytest.mark.parametrize("fc2", [False, True])
@pytest.mark.parametrize("KN", [(348, 348), (128, 512), (512, 128), (64, 256),
                                (256, 64), (16, 32), (40, 6), (24, 5),
                                (424, 1696), (1696, 424)])
def test_ffn_gemm_kernel_sums_every_k_column(dev, KN, fc2):
    """The bf16-weight GEMM at M 392 (three 128-row tiles and 8 rows), K 348
    (padded to 352; the last 64-column stage mostly zeros) with N 348 (a
    partial 128-column tile), the 28x28 and 56x56 widths, K 16 / N 32, and
    N 6 and 5 (fp32 rows that are no whole 16 bytes: stored from registers,
    in pairs and singly). Kernel and plain version round the same inputs to
    bf16 and sum in fp32, so fc1's fp32 output holds rtol 1e-4, atol 1e-4 *
    max|plain| and fc2's bf16 output two bf16 ulps (1e-2): the plain product
    without the last 28 columns of K fails that tolerance."""
    K, N = KN
    g = torch.Generator().manual_seed(K + N)
    a = _rand(g, (392, K), dev, 1.0,
              torch.float32 if fc2 else torch.bfloat16)
    w = _rand(g, (N, K), dev, .05, torch.bfloat16).t()   # nn.Linear's rows
    b = _rand(g, (N,), dev, .1)
    od = torch.bfloat16 if fc2 else torch.float32
    tol = 1e-2 if fc2 else 1e-4

    def close(got, want):
        want = want.float()
        return torch.allclose(got.float(), want, rtol=tol,
                              atol=tol * want.abs().max().item())
    got = ffn_gemm(a, w, b, od)
    assert got.dtype == od and torch.isfinite(got.float()).all()
    assert close(got, ffn_gemm_ref(a, w, b, od))
    if K > 28:
        assert not close(got, ffn_gemm_ref(a[:, :K - 28], w[:K - 28], b, od))


# (M, K, N): the six fc1/fc2 shapes of a b2 forward (M = 2 * H * W), then M 1
# and M 200 (not a multiple of a tile's rows), N 1 / 87 (rows that are no
# whole float4s) / 348 / 1392, K 4 (one stage), 345 (padded to 348) and
# 1392, three b32 shapes, and gm_base's b2 fc1 and fc2 at 14x14; both tiles
# run, 128 x 128 (N > 64) and 256 x 64 (N <= 64).
F32_GEMM = [(392, 348, 1392), (392, 1392, 348), (1568, 128, 512),
            (1568, 512, 128), (6272, 64, 256), (6272, 256, 64),
            (1, 1392, 348), (200, 345, 87), (200, 4, 1), (391, 1392, 1),
            (1000, 64, 1392), (6272, 348, 87), (6272, 348, 1392),
            (25088, 512, 128), (100352, 256, 64), (392, 424, 1696),
            (392, 1696, 424)]


@pytest.mark.parametrize("MKN", F32_GEMM,
                         ids=lambda s: "M{}-K{}-N{}".format(*s))
@pytest.mark.parametrize("offset", [0, 1])
def test_ffn_gemm_kernel_sums_every_k_column_fp32(dev, MKN, offset):
    """The fp32-weight GEMM (the CLIs' fp32 route) against ffn_gemm_ref at
    the fp32 tolerance, on nn.Linear's (N, K) weight as CustomFfn passes it
    (no copy) and, with ``offset`` 1, on an A whose base is one element
    off 16 bytes (the wrapper copies it). Two calls give the same bits, and
    the plain product without the last 28 columns of K fails the
    tolerance."""
    M, K, N = MKN
    g = torch.Generator().manual_seed(M + K + N)
    a = _rand(g, (M * K + offset,), dev)[offset:].view(M, K)
    w = _rand(g, (N, K), dev, .05).t()
    b = _rand(g, (N,), dev, .1)

    def close(got, want):
        return torch.allclose(got, want, rtol=1e-4,
                              atol=1e-4 * want.abs().max().item())
    got = ffn_gemm(a, w, b, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.isfinite(got).all()
    assert close(got, ffn_gemm_ref(a, w, b, torch.float32))
    assert torch.equal(got, ffn_gemm(a, w, b, torch.float32))
    if K > 28:
        assert not close(got, ffn_gemm_ref(a[:, :K - 28], w[:K - 28], b,
                                           torch.float32))


def test_ffn_gemm_fp32_reads_linear_weight_in_place(dev):
    """CustomFfn's fp32 GEMMs launch on the weight's own storage: the
    operand helper returns ``fc.weight.t()``'s (N, K) storage itself, so a
    forward makes no weight copy."""
    from ceigm_unet_tpu_torch.ops.ffn import gemm_operands
    fc = torch.nn.Linear(348, 1392).to(dev)
    a = torch.randn((392, 348), device=dev)
    ac, wc = gemm_operands(a, fc.weight.t())
    assert ac.data_ptr() == a.data_ptr()
    assert wc.data_ptr() == fc.weight.data_ptr()
    with torch.no_grad():
        got = ffn_gemm(a, fc.weight.t(), fc.bias, torch.float32)
        want = ffn_gemm_ref(a, fc.weight.t(), fc.bias, torch.float32)
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# batch 32 at 28->56 (12.8M outputs) runs many blocks; C 348 (cg 87) has
# channel items that straddle two groups; C 12 (cg 3) has groups narrower
# than an item, on 24-byte rows; C 512, gm_small's and gm_base's 7x7 source
@pytest.mark.parametrize("BHWC", [(2, 7, 7, 448), (2, 28, 28, 128),
                                  (32, 28, 28, 128), (2, 14, 14, 348),
                                  (2, 5, 7, 12), (2, 7, 7, 512)])
# offsets in pixels; at 60 most of the grid lies far outside [-1, 1], so
# the border clamp acts on all four edges
@pytest.mark.parametrize("offset_scale", [0.1, 3.0, 60.0])
def test_grid_sample_kernel(dev, BHWC, dtype, offset_scale):
    B, H, W, C = BHWC
    g = torch.Generator().manual_seed(C)
    x = _rand(g, (B, H, W, C), dev, 1.0, DT[dtype])
    base = torch.stack(torch.meshgrid(
        (torch.arange(2 * H) + 0.5) / H - 1, (torch.arange(2 * W) + 0.5) / W
        - 1, indexing="ij")[::-1], dim=-1)                  # (2H, 2W, 2)
    grid = base[None, :, :, None, :].to(dev) + _rand(
        g, (B, 2 * H, 2 * W, 4, 2), dev, offset_scale / max(H, W))
    if offset_scale > 10:
        assert (grid < -2).any() and (grid > 2).any()
    _close(dysample_grid_sample(x, grid), dysample_grid_sample_ref(x, grid),
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# the three b128 model shapes at b2 (C2 174 = 5 * 32 + 14: a partial last
# chunk, 8-byte items in bf16); C 2 (one c2) and 6; H below a strip (3, 1),
# W over one tile (two tiles of 20 and of 17), W below a strip, H != W;
# gm_base's 14x14 C424 (C2 212 = 6 * 32 + 20) and 56x56 C96
@pytest.mark.parametrize("HWC", [(14, 14, 348), (28, 28, 128), (56, 56, 64),
                                 (5, 7, 6), (3, 40, 2), (9, 4, 64),
                                 (16, 33, 128), (1, 5, 348), (14, 14, 424),
                                 (56, 56, 96)])
def test_lgag_kernel(dev, HWC, dtype):
    H, W, C = HWC
    g = torch.Generator().manual_seed(C + H)
    C2 = C // 2
    gx = [_rand(g, (2, H, W, C), dev, 1.0, DT[dtype]) for _ in range(2)]
    prm = [_rand(g, (5, 5, 2, C2), dev, .2), 1 + _rand(g, (C2,), dev, .1),
           _rand(g, (C2,), dev, .1), _rand(g, (C2,), dev, .3),
           _rand(g, (3,), dev, .5)]
    _build.reset_launch_counts()
    got = lgag_gate(*gx, *prm)
    assert dict(_build.launch_counts) == {"lgag_gate": 1}
    assert got.dtype == DT[dtype]
    _close(got, lgag_gate_ref(*gx, *prm), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lgag_kernel_unaligned_operands(dev, dtype):
    """g and x starting one element into their storage (a 2-byte aligned
    bf16 pointer): the wrapper copies them to an aligned buffer, the
    kernel takes the narrowest item, the result holds."""
    H, W, C = 9, 10, 64
    g = torch.Generator().manual_seed(5)
    n = 2 * H * W * C
    gx = [_rand(g, (n + 1,), dev, 1.0, DT[dtype])[1:].view(2, H, W, C)
          for _ in range(2)]
    prm = [_rand(g, (5, 5, 2, C // 2), dev, .2),
           1 + _rand(g, (C // 2,), dev, .1), _rand(g, (C // 2,), dev, .1),
           _rand(g, (C // 2,), dev, .3), _rand(g, (3,), dev, .5)]
    _close(lgag_gate(*gx, *prm), lgag_gate_ref(*gx, *prm), dtype)


def test_wrappers_raise_on_unsupported_dtype(dev):
    x = torch.zeros((1, 4, 4, 8), device=dev, dtype=torch.float16)
    grid = torch.zeros((1, 8, 8, 4, 2), device=dev)
    with pytest.raises(TypeError):
        dysample_grid_sample(x, grid)


def test_gm_test_model_on_card_matches_cpu_and_counts_launches(dev):
    model = build_model(enc_name="gm_test", device="cpu")
    x = torch.randn((2, 64, 64, 1), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(x)
        model.to(dev)
        _build.reset_launch_counts()
        got = model(x.to(dev))
        torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    # 4 encoder + 7 decoder quad blocks; 7 CustomFfn (2 GEMMs + the
    # stencil between them each); 3 DySample; 3 LGAG
    assert counts == {"quad_scan_ln": 11, "cffn_gemm": 14,
                      "cffn_dw3_inception7": 7, "dysample_grid_sample": 3,
                      "lgag_gate": 3}
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


def test_predict_volume_stages_the_maps_on_card(dev, monkeypatch):
    """The staged copy path on the card: at b4 over a 2-batch padded
    volume the int32 maps equal, bitwise, the plain loop's run on the same
    card with the same seeded gm_test model; a second call does not touch
    the first's array; the staging buffer is pinned and one padded volume
    of uint8; under a profiler each ``.download`` span reports 1 byte a
    pixel."""
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(served, "_staging", served._Staging())
    monkeypatch.setattr(spans, "_recorder", spans._Recorder())
    model = build_model(enc_name="gm_test", device=dev, seed=2).eval()
    rng = np.random.default_rng(3)
    vol = rng.random((6, 40, 40)).astype(np.float32)
    got = served.predict_volume(model, vol, (32, 32), 4)
    assert got.dtype == np.int32 and got.shape == vol.shape
    assert np.array_equal(got, plain_predict_volume(model, vol, (32, 32), 4))
    kept = got.copy()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        served.predict_volume(model, rng.random((5, 40, 40)).astype(
            np.float32), (32, 32), 4)
    assert np.array_equal(got, kept)
    buf = served._staging.bufs[next(model.parameters()).device]
    assert buf.is_pinned() and buf.numel() == 8 * 40 * 40
    assert [r["counts"] for r in spans.records()
            if r["name"] == "predict_volume.download"] == \
        [{"bytes": 4 * 40 * 40}] * 2


# storage orders of a and b (permutations of (B, K, L, D), each its own
# inverse) as the backward hands them to K8: the quad scan's (B, L, K, D)
# GEMM outputs; the legacy scan's decay in dt's (K, B, L, D) and its
# adjoint's drive in the (B, L, K, D) x_dbl
SCAN2D_LAYOUTS = {"contiguous": ((0, 1, 2, 3), (0, 1, 2, 3)),
                  "model": ((0, 2, 1, 3), (0, 2, 1, 3)),
                  "legacy": ((1, 0, 2, 3), (0, 2, 1, 3))}


def _scan2d_operands(g, shape, dev, layout, long_memory=False):
    """a (decays in (0, 1), mostly near 1; or, with long memory, within
    1e-4 of 1, so the state carries across every run of a 56x56 walk) and
    b in ``layout``; "stride0" is a and b read through stride-0 views over
    K (one (B, 1, L, D) tensor each), as an expanded activation."""
    B, H, W, D = shape
    K, L = 4, H * W
    if layout == "stride0":
        a = torch.sigmoid(_rand(g, (B, 1, L, D), dev, 2.0) + 2.0)
        b = _rand(g, (B, 1, L, D), dev)
        return a.expand(B, K, L, D), b.expand(B, K, L, D)
    a = (1 - 1e-4 * torch.rand((B, K, L, D), generator=g).to(dev)
         if long_memory else torch.sigmoid(_rand(g, (B, K, L, D), dev, 2.0)
                                           + 2.0))
    b = _rand(g, (B, K, L, D), dev)
    return [t.permute(o).contiguous().permute(o)
            for t, o in zip((a, b), SCAN2D_LAYOUTS[layout])]


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "model", "legacy",
                                    "stride0"])
# gm_tiny b48 224x224: stage 1 (56x56, D 16), stage 3 (14x14, D 87) and
# stage 4 (7x7, D 112) with 388 blocks, a partial last wave; gm_base's
# 14x14 D106 and 28x28 D48 at b48; the legacy
# tiny_0230s widths: stage 1 (D 96), stage 4 (D 768, six channel tiles); a
# ragged 200 (two tiles of 25 16-byte items); L 15 and 117, below and not a
# multiple of a run, with H != W under the column walks; D 1, 6 and 3 (4-,
# 8- and 4-byte accesses); D 128
@pytest.mark.parametrize("shape", [(48, 56, 56, 16), (48, 14, 14, 87),
                                   (97, 7, 7, 112), (1, 3, 5, 128),
                                   (2, 56, 56, 96), (3, 6, 8, 200),
                                   (4, 7, 7, 768), (2, 3, 5, 16),
                                   (3, 13, 9, 32), (2, 6, 10, 1),
                                   (2, 5, 7, 6), (2, 9, 4, 3),
                                   (48, 14, 14, 106), (48, 28, 28, 48)])
def test_scan2d_kernel(dev, shape, adjoint, layout):
    B, H, W, D = shape
    g = torch.Generator().manual_seed(D)
    a, b = _scan2d_operands(g, shape, dev, layout)
    kern, ref = ((scan2d_adjoint, scan2d_adjoint_ref) if adjoint
                 else (scan2d, scan2d_ref))
    for dirs in ((1, 2, 3, 4), (4, 3, 2, 1)):
        got = kern(a, b, H, W, dirs)
        assert got.is_contiguous()
        _close(got, ref(a.contiguous(), b.contiguous(), H, W, dirs),
               "float32")


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("shape", [(2, 56, 56, 16), (2, 56, 56, 96),
                                   (3, 13, 9, 87)])
def test_scan2d_kernel_long_memory(dev, shape, adjoint):
    """Decays within 1e-4 of 1 over 3136 pixels: the state carries across
    every run and round of the walk, so a wrong carry-in shows far above
    the fp32 tolerance."""
    B, H, W, D = shape
    g = torch.Generator().manual_seed(D + 1)
    a, b = _scan2d_operands(g, shape, dev, "model", long_memory=True)
    kern, ref = ((scan2d_adjoint, scan2d_adjoint_ref) if adjoint
                 else (scan2d, scan2d_ref))
    for dirs in ((1, 2, 3, 4), (4, 3, 2, 1)):
        _close(kern(a, b, H, W, dirs),
               ref(a.contiguous(), b.contiguous(), H, W, dirs), "float32")


def _inception_taps(g, HID, n_id, dev):
    """(7, 7, 1, HID) taps, random on [n_id, HID) and the identity (the
    centre tap 1) on [0, n_id), as the composite has them there; random
    bias on every channel."""
    k = _rand(g, (7, 7, 1, HID), dev, 0.1)
    k[:, :, :, :n_id] = 0.0
    k[3, 3, :, :n_id] = 1.0
    return k, _rand(g, (HID,), dev, 0.1)


@pytest.mark.parametrize("case", [
    # the three b128 model shapes at b2 (n_id 870 allows 8-byte tap items)
    (2, 14, 14, 1392, 870, 0, 0.1, "random"),
    (2, 28, 28, 512, 320, 0, 0.1, "random"),
    (2, 56, 56, 256, 160, 0, 0.1, "random"),
    # H below a strip, W over one tile (two tiles of 20); H != W
    (3, 5, 40, 96, 60, 0, 0.1, "random"), (2, 9, 37, 64, 24, 0, 0.1, "random"),
    # n_id 0 (every channel tapped) and HID (none); an odd n_id (4-byte
    # items); HID 90 (8-byte) and 87 (4-byte), a partial channel group
    (2, 11, 12, 128, 0, 0, 0.1, "random"),
    (2, 11, 12, 128, 128, 0, 0.1, "random"),
    (2, 10, 9, 128, 61, 0, 0.1, "random"), (2, 7, 13, 90, 30, 0, 0.1, "random"),
    (2, 8, 8, 87, 33, 0, 0.1, "random"),
    # the hidden's base pointer one element past a 16-byte boundary
    (2, 14, 14, 256, 160, 1, 0.1, "random"),
    # dwb of scale 3: a q outside the image computed as gelu(dwb), where
    # the 7x7's zero padding has 0, moves the border outputs far past the
    # tolerance
    (2, 9, 11, 128, 64, 0, 3.0, "random"),
    # the composite's taps: groups of reach 1, 2 and 3 (3x3, 5x5, 7x7); 28
    # rows walked as 4 strips by a tap block, 45 as 4 and 3 (a partial
    # strip last), 56 as two runs of 4
    (2, 28, 28, 512, 320, 0, 0.1, "composite"),
    (1, 45, 20, 256, 160, 0, 0.1, "composite"),
    (2, 56, 56, 256, 160, 0, 3.0, "composite"),
    # gm_base's 14x14 stencil: HID 1696, 212 channels a group, 1060 identity
    (2, 14, 14, 1696, 1060, 0, 0.1, "composite")],
    ids=lambda c: "b{}-{}x{}-HID{}-id{}-off{}-dwb{}-{}".format(*c))
def test_dw3_gelu_inception7_kernel(dev, case):
    """``dw3_gelu_inception7`` (K3's stencil between the GEMMs,
    ``cffn_dw3_inception7``) against ``dw3_gelu_inception7_ref`` at the
    fp32 tolerance."""
    B, H, W, HID, n_id, offset, dwb_scale, taps = case
    g = torch.Generator().manual_seed(HID + n_id)
    if taps == "composite":
        gb = HID // 8
        assert n_id == HID - 3 * gb
        k, bias = inception_composite(
            HID, gb, _rand(g, (3, 3, 1, gb), dev, .2),
            _rand(g, (5, 5, 1, gb), dev, .1),
            _rand(g, (7, 7, 1, gb), dev, .05),
            *[_rand(g, (gb,), dev, .1) for _ in range(3)], torch.float32)
    else:
        k, bias = _inception_taps(g, HID, n_id, dev)
    dwk, dwb = _rand(g, (3, 3, 1, HID), dev, 0.2), _rand(g, (HID,), dev,
                                                          dwb_scale)
    M = B * H * W
    h = _rand(g, (M * HID + offset,), dev)[offset:].view(M, HID)
    assert h.data_ptr() % 16 == 4 * offset
    _build.reset_launch_counts()
    got = dw3_gelu_inception7(h, dwk, dwb, k, bias, H, W, n_id)
    assert dict(_build.launch_counts) == {"cffn_dw3_inception7": 1}
    _close(got, dw3_gelu_inception7_ref(h, dwk, dwb, k, bias, H, W, n_id),
           "float32")


def _quad_leaves(g, B, H, W, D, dev, dtype):
    K, L = 4, H * W
    act = [_rand(g, (B, K, L, D), dev, s, dtype) for s in (1.0, 0.5)]
    act += [_rand(g, (B, K, L), dev, 1.0, dtype) for _ in range(2)]
    prm = [-torch.exp(_rand(g, (K, D), dev, 0.5)), _rand(g, (K, D), dev, .3),
           _rand(g, (K, D), dev), 1 + _rand(g, (K, D), dev, .1),
           _rand(g, (K, D), dev, .1)]
    return [t.requires_grad_() for t in act + prm]


@pytest.mark.parametrize("shape", [(2, 56, 56, 16), (3, 7, 7, 112)])
def test_quad_scan_backward_on_card_matches_cpu(dev, shape):
    B, H, W, D = shape
    g = torch.Generator().manual_seed(D)
    leaves = _quad_leaves(g, B, H, W, D, dev, torch.float32)
    go = _rand(g, (B, H * W, 4 * D), dev)
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    dirs = (1, 2, 3, 4)
    _build.reset_launch_counts()
    quad_scan_ln_cat(*leaves, H, W, dirs).backward(go)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"quad_scan_ln": 1, "scan2d": 2}
    quad_scan_ln_cat(*cpu, H, W, dirs).backward(go.cpu())
    for t, c in zip(leaves, cpu):
        torch.testing.assert_close(
            t.grad.cpu(), c.grad, rtol=1e-3,
            atol=2e-3 * c.grad.abs().max().item())


def test_kernel_ops_keep_the_autograd_graph(dev):
    """Every kernel op's output carries a grad_fn when an input requires
    grad, and the stage kernels without a backward refuse such inputs."""
    g = torch.Generator().manual_seed(0)
    leaves = _quad_leaves(g, 1, 4, 6, 8, dev, torch.float32)
    assert quad_scan_ln_cat(*leaves, 4, 6, (1, 2, 3, 4)).grad_fn is not None
    x = _rand(g, (1, 24, 16), dev).requires_grad_()
    gb = 4
    inck, incb = inception_composite(
        32, gb, _rand(g, (3, 3, 1, gb), dev), _rand(g, (5, 5, 1, gb), dev),
        _rand(g, (7, 7, 1, gb), dev), *[_rand(g, (gb,), dev)] * 3,
        torch.float32)
    args = [x, _rand(g, (16, 32), dev, .1), _rand(g, (32,), dev),
            _rand(g, (3, 3, 1, 32), dev), _rand(g, (32,), dev), inck, incb,
            _rand(g, (32, 16), dev, .1), _rand(g, (16,), dev)]
    assert custom_ffn_fused(*args, 4, 6, 12).grad_fn is not None
    xs = _rand(g, (1, 4, 4, 8), dev).requires_grad_()
    grid = torch.zeros((1, 8, 8, 4, 2), device=dev)
    assert dysample_grid_sample(xs, grid).grad_fn is not None
    prm = [_rand(g, (5, 5, 2, 4), dev), *[_rand(g, (4,), dev)] * 3,
           _rand(g, (3,), dev)]
    assert lgag_gate(xs, xs, *prm).grad_fn is not None
    u = _rand(g, (1, 4, 6, 8), dev).requires_grad_()
    bc = _rand(g, (1, 4, 6), dev)
    assert sscan_dir(u, u, bc, bc, *[_rand(g, (4, 8), dev)] * 3, 2, 3,
                     (1, 2, 3, 4)).grad_fn is not None
    v = _rand(g, (2, 8, 6), dev).requires_grad_()
    A = -torch.ones((8, 1), device=dev)
    B = _rand(g, (2, 1, 6), dev)
    assert selective_scan(v, v, A, B, B, delta_softplus=True).grad_fn \
        is not None
    with pytest.raises(RuntimeError, match="no backward"):
        ffn_gemm(x[0], args[1], args[2], torch.float32)


def _train_step_card_vs_cpu(dev, routes, want_counts, build=None,
                            cancelled=None):
    """One unfrozen AdamW step of gm_test built with ``routes`` (or of the
    model ``build(device=...)`` gives; decoder drop-path masks from one CPU
    generator on both sides): the loss, every parameter's gradient (finite)
    and the BN running statistics, card against CPU; and the launches of
    the step. Gradients whose names match ``cancelled`` have a true value
    of 0 (a per-channel constant ahead of a train-mode BatchNorm): both
    sides must stay below 1e-4 of the largest CPU gradient."""
    if build is None:
        build = lambda device: build_model(enc_name="gm_test", device=device,
                                           **routes)
    batch = {"image": torch.randn((4, 64, 64, 1), generator=torch.Generator(
        ).manual_seed(1)), "label": torch.randint(0, 9, (4, 64, 64),
                                                   generator=torch.Generator(
                                                   ).manual_seed(2))}
    runs = []
    for device in ("cpu", dev):
        model = build(device=device).train()
        step = make_train_step(model, make_optimizer(param_groups(model),
                                                     1e-3),
                               cosine_lr(5e-4, 1e-6, 300, 46))
        _build.reset_launch_counts()
        loss = step({k: v.to(device) for k, v in batch.items()},
                    generator=torch.Generator().manual_seed(3))["loss"]
        torch.cuda.synchronize()
        runs.append((loss.item(), model, dict(_build.launch_counts)))
    (l_cpu, m_cpu, _), (l_dev, m_dev, counts) = runs
    assert counts == want_counts
    assert abs(l_dev - l_cpu) <= 1e-4 * abs(l_cpu)
    cpu_p = dict(m_cpu.named_parameters())
    top = max(p.grad.abs().max().item() for p in cpu_p.values())
    for name, p in m_dev.named_parameters():
        want = cpu_p[name].grad
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        if cancelled is not None and cancelled.search(name):
            assert max(p.grad.abs().max().item(),
                       want.abs().max().item()) <= 1e-4 * top, name
            continue
        # 1e-8: a bias ahead of a train-mode BatchNorm has a true
        # gradient of 0 and holds only rounding noise (or an exact 0)
        torch.testing.assert_close(
            p.grad.cpu(), want, rtol=2e-3,
            atol=1e-8 + 2e-3 * want.abs().max().item(), msg=name)
    cpu_b = dict(m_cpu.named_buffers())
    for name, b in m_dev.named_buffers():
        if "running" in name:
            torch.testing.assert_close(b.cpu(), cpu_b[name], rtol=1e-4,
                                       atol=1e-5, msg=name)


def test_gm_test_train_step_on_card_matches_cpu(dev):
    # 11 quad blocks forward and 22 scans backward; 7 CustomFfn; 3
    # DySample; LGAG takes its unfolded form in training
    _train_step_card_vs_cpu(dev, {}, {
        "quad_scan_ln": 11, "scan2d": 22, "cffn_gemm": 14,
        "cffn_dw3_inception7": 7, "dysample_grid_sample": 3})


# --- the legacy VMamba slice: K10, K11, K12 --------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# the legacy model's 224x224 stage-1 and stage-4 SS2D shapes; a ragged tile
@pytest.mark.parametrize("shape", [(2, 56, 56, 96), (2, 7, 7, 768),
                                   (1, 5, 9, 40)])
def test_sscan_dir_kernel(dev, shape, dtype):
    B, H, W, D = shape
    g = torch.Generator().manual_seed(D)
    K, L = 4, H * W
    # u: the model's stride-0 view over the four directions
    u = _rand(g, (B, L, D), dev, 1.0, DT[dtype])[:, None].expand(B, K, L, D)
    dt = _rand(g, (B, K, L, D), dev, 0.5, DT[dtype])
    BC = [_rand(g, (B, K, L), dev, 1.0, DT[dtype]) for _ in range(2)]
    prm = [-torch.exp(_rand(g, (K, D), dev, 0.5)), _rand(g, (K, D), dev, .3),
           _rand(g, (K, D), dev)]
    for dirs in ((1, 2, 3, 4), (4, 3, 2, 1)):
        _close(sscan_dir(u, dt, *BC, *prm, H, W, dirs),
               sscan_dir_ref(u, dt, *BC, *prm, H, W, dirs), dtype)
    # dt as the model passes it: a (K, B, L, D) GEMM output, permuted
    dt_kb = dt.permute(1, 0, 2, 3).contiguous().permute(1, 0, 2, 3)
    _close(sscan_dir(u, dt_kb, *BC, *prm, H, W, (1, 2, 3, 4)),
           sscan_dir_ref(u, dt, *BC, *prm, H, W, (1, 2, 3, 4)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# L shorter than a 16-pixel chunk (3x4), L not a multiple of it (5x9, 7x7),
# a column walk with H > W (50x3); D 40 (a ragged channel tile) and 768;
# 37 x 3 (b, k) chains of three tiles, whose last wave of blocks is partial
@pytest.mark.parametrize("shape,dirs", [
    ((1, 3, 4, 40), (1, 2, 3, 4)), ((2, 5, 9, 40), (4, 3, 2, 1)),
    ((2, 7, 7, 768), (1, 2, 3, 4)), ((1, 50, 3, 33), (2, 4)),
    ((37, 14, 14, 96), (2, 4, 1))])
def test_sscan_dir_kernel_edges(dev, shape, dirs, dtype):
    B, H, W, D = shape
    g = torch.Generator().manual_seed(D + H)
    K, L = len(dirs), H * W
    u = _rand(g, (B, L, D), dev, 1.0, DT[dtype])[:, None].expand(B, K, L, D)
    dt = _rand(g, (B, K, L, D), dev, 0.5, DT[dtype])
    BC = [_rand(g, (B, K, L), dev, 1.0, DT[dtype]) for _ in range(2)]
    prm = [-torch.exp(_rand(g, (K, D), dev, 0.5)), _rand(g, (K, D), dev, .3),
           _rand(g, (K, D), dev)]
    got = sscan_dir(u, dt, *BC, *prm, H, W, dirs)
    assert got.dtype == torch.float32 and got.is_contiguous()
    _close(got, sscan_dir_ref(u, dt, *BC, *prm, H, W, dirs), dtype)


# rows x L: the b8 N16 56x56 shape's L, a chunk's ragged end, L = 1
@pytest.mark.parametrize("ML", [(13, 3136), (7, 300), (5, 1), (1, 4096)])
def test_scan_rows_kernel(dev, ML):
    M, L = ML
    g = torch.Generator().manual_seed(L)
    a = torch.sigmoid(_rand(g, (M, L), dev, 2.0) + 2.0)
    b = _rand(g, (M, L), dev)
    _close(scan_rows(a, b), scan_rows_ref(a, b), "float32")


# (u, delta, B and C, out dtypes; G, dim; L; B and C 3-D; D and bias; u's
# base one element off 16 bytes (the element path); long memory). batch 3:
# M = 15, 18 and 36 rows are not all multiples of the 2, 4 or 8 rows a
# block takes; L 1, 7, 300 and 4099 end inside a chunk or a round.
F, H = "float32", "bfloat16"
N1_CASES = [
    (F, F, F, F, 1, 8, 4096, False, True, False, False),
    (H, H, H, F, 1, 8, 4096, False, True, False, False),
    (H, H, H, H, 1, 8, 4096, False, True, False, False),
    (F, F, F, F, 2, 8, 300, False, False, False, False),
    (H, H, H, F, 2, 8, 300, False, False, False, False),
    (H, H, H, H, 2, 8, 300, False, False, False, False),
    (H, H, H, F, 1, 5, 1, True, True, False, False),
    (F, F, F, H, 1, 5, 7, True, False, False, False),
    (H, H, F, F, 2, 6, 7, False, True, False, False),
    (F, H, H, F, 2, 6, 300, False, True, False, False),
    (F, H, F, F, 1, 5, 4096, True, False, False, False),
    (H, H, H, F, 4, 12, 4099, False, True, False, False),
    (H, F, H, H, 4, 12, 4096, False, False, False, False),
    (F, F, H, F, 1, 5, 4099, True, True, False, False),
    (H, H, H, F, 1, 5, 4096, False, True, True, False),
    (F, F, F, F, 2, 6, 300, False, True, True, False),
    (H, H, H, F, 2, 6, 16384, False, True, False, True),
    (F, F, F, F, 1, 5, 16384, True, True, False, True),
]


@pytest.mark.parametrize("case", N1_CASES)
def test_selective_scan_n1_kernel(dev, case):
    """K12 against its plain version. Long memory: A = -exp(-8) and a
    delta bias near -2 keep each step's decay within 1e-4 of 1, so the
    state carries across every chunk and round of a 16384-step row."""
    ut, dtt, bct, out, G, dim, L, three_d, with_opt, offset, long_mem = case
    batch = 3
    g = torch.Generator().manual_seed(L + G)
    n = batch * dim * L
    u = _rand(g, (n + offset,), dev, 1.0, DT[ut])[offset:].view(
        batch, dim, L)
    delta = _rand(g, (batch, dim, L), dev, 0.5, DT[dtt])
    A = (torch.full((dim, 1), -math.exp(-8.0), device=dev) if long_mem
         else -torch.exp(_rand(g, (dim, 1), dev, 0.5)))
    bc = (batch, 1, L) if three_d else (batch, G, 1, L)
    B, C = [_rand(g, bc, dev, 1.0, DT[bct]) for _ in "BC"]
    D, bias = ((_rand(g, (dim,), dev),
                _rand(g, (dim,), dev, .3) - (2.0 if long_mem else 0.0))
               if with_opt else (None, None))
    got = selective_scan_n1(u, delta, A, B, C, D, bias, DT[out])
    assert got.dtype == DT[out]
    _close(got, selective_scan_n1_ref(u, delta, A, B, C, D, bias, DT[out]),
           H if H in (ut, dtt, bct, out) else F)


def test_selective_scan_n1_makes_no_copies(dev):
    """At bf16 u, delta, B and C with L % 8 == 0 (the speed test's dtypes),
    a call allocates y and nothing else, and launches K12 once."""
    g = torch.Generator().manual_seed(3)
    batch, dim, L = 4, 16, 1024
    u, delta = [_rand(g, (batch, dim, L), dev, s, torch.bfloat16)
                for s in (1.0, 0.5)]
    A = -torch.exp(_rand(g, (dim, 1), dev, 0.5))
    B, C = [_rand(g, (batch, 1, 1, L), dev, 1.0, torch.bfloat16)
            for _ in "BC"]
    D, bias = _rand(g, (dim,), dev), _rand(g, (dim,), dev, .3)
    args = (u, delta, A, B, C, D, bias, torch.float32)
    selective_scan_n1(*args)          # the build, and any first-call state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    y = selective_scan_n1(*args)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"selective_scan_n1": 1}
    assert torch.cuda.max_memory_allocated() - before == 4 * y.numel()
    _close(y, selective_scan_n1_ref(*args), "bfloat16")


def test_selective_scan_routes_to_its_kernels(dev):
    """N = 1 with softplus launches K12; N = 4, or return_last_state,
    launches K11; each result equals the plain route on the CPU."""
    g = torch.Generator().manual_seed(1)
    batch, dim, L = 2, 8, 500
    u, delta = _rand(g, (batch, dim, L), dev), _rand(g, (batch, dim, L), dev)
    D, bias = _rand(g, (dim,), dev), _rand(g, (dim,), dev, .3)
    for N, last, launched in ((1, False, "selective_scan_n1"),
                              (4, False, "scan_rows"),
                              (1, True, "scan_rows")):
        A = -torch.exp(_rand(g, (dim, N), dev, 0.5))
        B, C = [_rand(g, (batch, 2, N, L), dev) for _ in "BC"]
        args = (u, delta, A, B, C, D, bias)
        _build.reset_launch_counts()
        got = selective_scan(*args, delta_softplus=True,
                             return_last_state=last)
        torch.cuda.synchronize()
        assert dict(_build.launch_counts) == {launched: 1}
        want = selective_scan(*[t.cpu() for t in args], delta_softplus=True,
                              return_last_state=last)
        for a, b in zip(*((got, want) if last else ((got,), (want,)))):
            _close(a, b, "float32")


def test_scan_kernels_refuse_inputs_that_require_grad(dev):
    """The raw row-scan ops (K11, K12), which selective_scan's autograd op
    calls in no-grad mode, refuse inputs that require grad."""
    g = torch.Generator().manual_seed(2)
    a = _rand(g, (2, 8), dev).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        scan_rows(a, a)
    u = _rand(g, (2, 4, 6), dev).requires_grad_()
    bc = _rand(g, (2, 1, 6), dev)
    with pytest.raises(RuntimeError, match="no backward"):
        selective_scan_n1(u, u, -torch.ones((4, 1), device=dev), bc, bc)


def test_vssm_test_legacy_model_on_card_matches_cpu_and_counts_launches(dev):
    model = build_legacy_model(enc_name="vssm_test", device="cpu")
    x = torch.randn((2, 64, 64, 1), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(x)
        model.to(dev)
        _build.reset_launch_counts()
        got = model(x.to(dev))
        torch.cuda.synchronize()
    # 4 encoder + 6 decoder SS2D blocks, all at d_state 1
    assert dict(_build.launch_counts) == {"sscan_dir": 10}
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3,
                               atol=1e-3 * want.abs().max().item())


# --- the legacy training slice: K10's backward through K8, K11's ------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# tiny_0230s stage 3 (14x14, D 384: three channel tiles); a ragged map
@pytest.mark.parametrize("shape", [(2, 14, 14, 384), (1, 6, 8, 40)])
def test_sscan_dir_backward_on_card_matches_cpu(dev, shape, dtype):
    """sscan_dir's seven grads on the card (K10 forward, K8 twice in the
    backward) against the same autograd op on the CPU; u a stride-0 view
    over K. fp32 at the gradient tolerance; bf16 grads, rounded from fp32
    once on each side, at the bf16 one."""
    B, H, W, D = shape
    g = torch.Generator().manual_seed(D)
    K, L = 4, H * W
    dt_ = DT[dtype]
    base = [_rand(g, (B, L, D), dev, 1.0, dt_),
            _rand(g, (B, K, L, D), dev, 0.5, dt_),
            _rand(g, (B, K, L), dev, 1.0, dt_),
            _rand(g, (B, K, L), dev, 1.0, dt_),
            -torch.exp(_rand(g, (K, D), dev, 0.5)), _rand(g, (K, D), dev, .3),
            _rand(g, (K, D), dev)]
    gy = _rand(g, (B, K, L, D), dev)
    grads = []
    for device in (dev, "cpu"):
        leaves = [t.detach().to(device).requires_grad_() for t in base]
        u = leaves[0][:, None].expand(B, K, L, D)
        _build.reset_launch_counts()
        sscan_dir(u, *leaves[1:], H, W, (1, 2, 3, 4)).backward(gy.to(device))
        if device == dev:
            torch.cuda.synchronize()
            assert dict(_build.launch_counts) == {"sscan_dir": 1,
                                                  "scan2d": 2}
        grads.append([t.grad for t in leaves])
    rtol, atol = (2e-3, 2e-3) if dtype == "float32" else TOL[dtype]
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        torch.testing.assert_close(
            got.cpu().float(), want.float(), rtol=rtol,
            atol=atol * want.float().abs().max().item())


@pytest.mark.parametrize("N,last", [(1, False), (16, False), (1, True)])
def test_selective_scan_backward_on_card_matches_cpu(dev, N, last):
    """selective_scan's seven grads on the card against the CPU, on the K12
    route (N 1), the K11 route (N 16) and with return_last_state; the
    backward launches K11 exactly twice on each."""
    g = torch.Generator().manual_seed(N)
    batch, dim, L = 2, 16, 300
    base = [_rand(g, (batch, dim, L), dev),
            _rand(g, (batch, dim, L), dev, 0.5),
            -torch.exp(_rand(g, (dim, N), dev, 0.5)),
            _rand(g, (batch, 2, N, L), dev), _rand(g, (batch, 2, N, L), dev),
            _rand(g, (dim,), dev), _rand(g, (dim,), dev, 0.3)]
    gy, gh = _rand(g, (batch, dim, L), dev), _rand(g, (batch, dim, N), dev)
    grads = []
    for device in (dev, "cpu"):
        leaves = [t.detach().to(device).requires_grad_() for t in base]
        out = selective_scan(*leaves, delta_softplus=True,
                             return_last_state=last, out_dtype=torch.float32)
        if device == dev:
            torch.cuda.synchronize()
            _build.reset_launch_counts()
        loss = ((out[0] * gy.to(device)).sum() + (out[1] * gh.to(device))
                .sum() if last else (out * gy.to(device)).sum())
        loss.backward()
        if device == dev:
            torch.cuda.synchronize()
            assert dict(_build.launch_counts) == {"scan_rows": 2}
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got.cpu(), want, rtol=2e-3,
                                   atol=2e-3 * want.abs().max().item())


# vssm_test biases whose true gradient is 0: a per-channel constant ahead of
# a train-mode BatchNorm (tests/test_torch_legacy_train.py's list)
VSSM_TEST_BN_CANCELLED = re.compile(
    r"(decoder\.(layers\.\d\.up|out_layers\.0)\.expand\.0\.bias"
    r"|(decoder\.layers\.\d\.vss_layer\.blocks\.1|encoder\.layers\.3\."
    r"blocks\.0)\.mlp\.(fc2|multiscale_conv\.dwconv_(hw\.2|w\.1|h\.1))"
    r"\.bias)$")


def test_vssm_test_legacy_train_step_on_card_matches_cpu(dev):
    # 10 SS2D blocks: K10 once each forward, K8 twice each backward
    _train_step_card_vs_cpu(
        dev, {}, {"sscan_dir": 10, "scan2d": 20},
        build=lambda device: build_legacy_model(enc_name="vssm_test",
                                                device=device),
        cancelled=VSSM_TEST_BN_CANCELLED)


# --- the kernel routes: K6/K7 (single-grid grid-sample), K13, K14 ------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# DySample's per-group images at 224x224 and batch 2 (4 groups each), a
# non-2x output, an odd C (13: 26- and 52-byte rows, one element per
# access) and 24-byte bf16 rows (8-byte aligned, not 16); x_offset starts
# x one element into its storage, so its pointer is not 16-byte aligned
@pytest.mark.parametrize("shape,x_offset", [
    ((8, 7, 7, 112, 14, 14), 0), ((8, 14, 14, 87, 28, 28), 0),
    ((8, 28, 28, 32, 56, 56), 0), ((2, 9, 13, 20, 11, 30), 0),
    ((3, 6, 5, 13, 9, 11), 0), ((2, 5, 7, 12, 10, 14), 0),
    ((2, 7, 7, 112, 14, 14), 1)])
def test_grid_sample_bilinear_kernel(dev, shape, x_offset, dtype):
    B, H, W, C, Ho, Wo = shape
    g = torch.Generator().manual_seed(C)
    n = B * H * W * C
    x = _rand(g, (n + x_offset,), dev, 1.0, DT[dtype])[x_offset:].view(
        B, H, W, C)
    grid = (torch.rand((B, Ho, Wo, 2), generator=g) * 2.4 - 1.2).to(dev)
    got = grid_sample_bilinear_fused(x, grid)
    assert got.dtype == DT[dtype]
    _close(got, grid_sample_bilinear(x, grid), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# gm_tiny's quad-block convs at 56x56 and 7x7, a ragged tile and channel
# block; x is the channel slice of a (B*H*W, 2C) tensor, as in the model
@pytest.mark.parametrize("shape", [(2, 56, 56, 64), (2, 14, 14, 348),
                                   (2, 7, 7, 448), (1, 9, 11, 35)])
def test_dwconv3x3_kernel(dev, shape, dtype):
    B, H, W, C = shape
    g = torch.Generator().manual_seed(C)
    xz = _rand(g, (B * H * W, 2 * C), dev, 1.0, DT[dtype])
    x = xz[:, :C].view(B, H, W, C)
    w, b = _rand(g, (C, 1, 3, 3), dev, 0.3), _rand(g, (C,), dev, 0.1)
    got = dwconv3x3(x, w, b)
    assert got.dtype == DT[dtype] and got.is_contiguous()
    _close(got, dwconv3x3_ref(x, w, b), dtype)
    gy = _rand(g, (B, H, W, C), dev, 1.0, DT[dtype])
    _close(dwconv3x3_flip(gy, w), dwconv3x3_ref(gy, w, flip=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# layout of x: the channel slice of a (B*H*W, 2C) tensor (16-byte pixel
# pitch for C 348 in bf16), a contiguous tensor (8-byte pitch for C 348 in
# bf16), or a contiguous one starting one element into its storage (no
# vector access)
@pytest.mark.parametrize("layout", ["slice", "contiguous", "offset"])
# C not a multiple of the 4-channel item (35, 87); H or W below a strip of
# 8 rows (1, 2, 3) or not a multiple of it (10, 17)
@pytest.mark.parametrize("shape", [(2, 1, 5, 35), (2, 2, 3, 87),
                                   (1, 3, 1, 348), (2, 17, 10, 348),
                                   (1, 9, 2, 64), (3, 10, 7, 12)])
def test_dwconv3x3_kernel_edges(dev, shape, layout, dtype):
    B, H, W, C = shape
    g = torch.Generator().manual_seed(C + H)
    n = B * H * W * C
    if layout == "slice":
        x = _rand(g, (B * H * W, 2 * C), dev, 1.0, DT[dtype])[:, :C].view(
            B, H, W, C)
    else:
        skip = int(layout == "offset")
        x = _rand(g, (n + skip,), dev, 1.0, DT[dtype])[skip:].view(
            B, H, W, C)
    w, b = _rand(g, (C, 1, 3, 3), dev, 0.3), _rand(g, (C,), dev, 0.1)
    got = dwconv3x3(x, w, b)
    assert got.dtype == DT[dtype] and got.is_contiguous()
    _close(got, dwconv3x3_ref(x, w, b), dtype)
    _close(dwconv3x3_flip(x, w), dwconv3x3_ref(x, w, flip=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 56, 56, 16), (2, 14, 14, 87),
                                   (3, 7, 7, 112), (1, 5, 9, 8),
                                   *LONG_MEMORY])
def test_quad_scan_ln_q8_kernel(dev, shape, dtype):
    """The int8 scan (Bs/Cs in ``dtype``), bf16 out, at the bf16
    tolerance."""
    B, H, W, D, *long_memory = shape
    g = torch.Generator().manual_seed(D)
    K, L = 4, H * W
    (uq, su), (dq, sdt) = [q8(_rand(g, (B, L, K, D), dev, s))
                           for s in (1.0, 0.5)]
    BC = [_rand(g, (B, K, L), dev, 1.0, DT[dtype]) for _ in range(2)]
    prm = _quad_prm(g, K, D, dev, bool(long_memory))
    for dirs in ((1, 2, 3, 4), (4, 3, 2, 1)):
        args = [uq.permute(0, 2, 1, 3), dq.permute(0, 2, 1, 3), su, sdt, *BC,
                *prm, H, W, dirs]
        got = quad_scan_ln_cat_q8(*args)
        assert got.dtype == torch.bfloat16
        _close(got, quad_scan_ln_cat_q8_ref(*args), "bfloat16")


def test_route_ops_keep_the_autograd_graph(dev):
    """dwconv3x3 (backward: the flip kernel) and the single-grid
    grid-sample keep the graph and give the CPU's gradients; the flip
    kernel alone and the int8 scan refuse inputs that require grad."""
    g = torch.Generator().manual_seed(4)
    B, H, W, C = 2, 9, 10, 40
    leaves = [_rand(g, (B, H, W, C), dev), _rand(g, (C, 1, 3, 3), dev, .3),
              _rand(g, (C,), dev, .1)]
    grid = (torch.rand((B, 13, 7, 2), generator=g) * 2 - 1).to(dev)
    go = {"dw": _rand(g, (B, H, W, C), dev), "gs": _rand(g, (B, 13, 7, C),
                                                         dev)}
    for name, fn, ins, launched in (
            ("dw", dwconv3x3, leaves, {"dwconv3x3": 1, "dwconv3x3_flip": 1}),
            ("gs", grid_sample_bilinear_fused, [leaves[0], grid],
             {"grid_sample_bilinear": 1})):
        grads = []
        for device in (dev, "cpu"):
            ts = [t.detach().to(device).requires_grad_() for t in ins]
            _build.reset_launch_counts()
            out = fn(*ts)
            assert out.grad_fn is not None
            out.backward(go[name].to(device))
            if device == dev:
                torch.cuda.synchronize()
                assert dict(_build.launch_counts) == launched
            grads.append([t.grad.cpu() for t in ts])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-4 * b.abs().max().item())
    with pytest.raises(RuntimeError, match="no backward"):
        dwconv3x3_flip(leaves[0].requires_grad_(), leaves[1])
    u = _rand(g, (1, 90, 4, 8), dev)
    (uq, su), (dq, sdt) = q8(u), q8(0.5 * u)
    bc = _rand(g, (1, 4, 90), dev)
    prm = [_rand(g, (4, 8), dev).requires_grad_() for _ in range(5)]
    with pytest.raises(NotImplementedError, match="inference-only"):
        quad_scan_ln_cat_q8(uq.permute(0, 2, 1, 3), dq.permute(0, 2, 1, 3),
                            su, sdt, bc, bc, *prm, 9, 10, (1, 2, 3, 4))


@pytest.mark.parametrize("routes,launches", [
    # K13 in the 11 quad blocks; the per-group DySample route in the 3
    # upsamplers, once each
    (dict(dwconv="kernel", dysample_grouped=False),
     {"quad_scan_ln": 11, "dwconv3x3": 11, "cffn_gemm": 14,
      "cffn_dw3_inception7": 7, "grid_sample_bilinear": 3, "lgag_gate": 3}),
    # K14 in place of K1 in the 11 quad blocks
    (dict(quant_scan=True),
     {"quad_scan_ln_q8": 11, "cffn_gemm": 14, "cffn_dw3_inception7": 7,
      "dysample_grid_sample": 3, "lgag_gate": 3})])
def test_gm_test_routes_on_card_match_cpu_and_count_launches(dev, routes,
                                                             launches):
    """Card against CPU, fp32: the kernel routes at the model's tolerance
    (rtol 1e-3, atol 1e-3 * max); the int8 route within 0.05 * max (its
    bf16 scan output and a possible flipped int8 step)."""
    model = build_model(enc_name="gm_test", device="cpu", **routes)
    x = torch.randn((2, 64, 64, 1), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(x)
        model.to(dev)
        _build.reset_launch_counts()
        got = model(x.to(dev))
        torch.cuda.synchronize()
    assert dict(_build.launch_counts) == launches
    scale = want.abs().max().item()
    if routes.get("quant_scan"):
        assert (got.cpu() - want).abs().max().item() <= 0.05 * scale
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3,
                                   atol=1e-3 * scale)


def test_gm_test_kernel_routes_train_step_on_card_matches_cpu(dev):
    # forward: K13 in the 11 quad blocks, the single-grid grid-sample in
    # the 3 upsamplers; backward: K13's flip mode 11 times, K8 22 times
    _train_step_card_vs_cpu(dev, dict(dwconv="kernel",
                                      dysample_grouped=False), {
        "quad_scan_ln": 11, "scan2d": 22, "dwconv3x3": 11,
        "dwconv3x3_flip": 11, "cffn_gemm": 14, "cffn_dw3_inception7": 7,
        "grid_sample_bilinear": 3})
