"""The hand-written Hopper kernels against their plain PyTorch versions, on
an NVIDIA card. Every test is marked ``cuda`` and skips without a card.
This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 with TF32 off, rtol 1e-4 and atol 1e-4 * max|plain| (the
kernels sum in another order than the plain versions); bf16 rtol 3e-2 and
atol 5e-2 * max|plain| (tests/test_kernel_matrix.py's bf16 row).
"""
import pytest
import torch

from ceigm_unet_tpu_torch.models import build_model
from ceigm_unet_tpu_torch.ops import _build
from ceigm_unet_tpu_torch.ops.ffn import (custom_ffn_fused,
                                          custom_ffn_fused_ref,
                                          inception_composite)
from ceigm_unet_tpu_torch.ops.grid_sample import (dysample_grid_sample,
                                                  dysample_grid_sample_ref)
from ceigm_unet_tpu_torch.ops.quad_scan import (quad_scan_ln_cat,
                                                quad_scan_ln_cat_ref)
from ceigm_unet_tpu_torch.ops.tapconv import lgag_gate, lgag_gate_ref

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 56, 56, 16), (2, 14, 14, 87),
                                   (3, 7, 7, 112), (1, 5, 9, 8),
                                   (2, 7, 7, 128)])
def test_quad_scan_ln_kernel(dev, shape, dtype):
    B, H, W, D = shape
    g = torch.Generator().manual_seed(D)
    L, K = H * W, 4
    act = [_rand(g, (B, K, L, D), dev, s, DT[dtype]) for s in (1.0, 0.5)]
    act += [_rand(g, (B, K, L), dev, 1.0, DT[dtype]) for _ in range(2)]
    prm = [-torch.exp(_rand(g, (K, D), dev, 0.5)), _rand(g, (K, D), dev, .3),
           _rand(g, (K, D), dev), 1 + _rand(g, (K, D), dev, .1),
           _rand(g, (K, D), dev, .1)]
    dirs = (1, 2, 3, 4)
    _close(quad_scan_ln_cat(*act, *prm, H, W, dirs),
           quad_scan_ln_cat_ref(*act, *prm, H, W, dirs), dtype)
    # the model's strided (B, L, K, D) GEMM-output views
    blkd = [a.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
            for a in act[:2]]
    _close(quad_scan_ln_cat(*blkd, *act[2:], *prm, H, W, (4, 3, 2, 1)),
           quad_scan_ln_cat_ref(*act, *prm, H, W, (4, 3, 2, 1)), dtype)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# batch 32 at 28->56 (12.8M outputs) repeats the kernel's grid-stride loop
@pytest.mark.parametrize("BHWC", [(2, 7, 7, 448), (2, 28, 28, 128),
                                  (32, 28, 28, 128)])
@pytest.mark.parametrize("offset_scale", [0.1, 3.0])
def test_grid_sample_kernel(dev, BHWC, dtype, offset_scale):
    B, H, W, C = BHWC
    g = torch.Generator().manual_seed(C)
    x = _rand(g, (B, H, W, C), dev, 1.0, DT[dtype])
    base = torch.stack(torch.meshgrid(
        (torch.arange(2 * H) + 0.5) / H - 1, (torch.arange(2 * W) + 0.5) / W
        - 1, indexing="ij")[::-1], dim=-1)                  # (2H, 2W, 2)
    grid = base[None, :, :, None, :].to(dev) + _rand(
        g, (B, 2 * H, 2 * W, 4, 2), dev, offset_scale / max(H, W))
    _close(dysample_grid_sample(x, grid), dysample_grid_sample_ref(x, grid),
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("HWC", [(14, 14, 348), (56, 56, 64), (5, 7, 6)])
def test_lgag_kernel(dev, HWC, dtype):
    H, W, C = HWC
    g = torch.Generator().manual_seed(C)
    C2 = C // 2
    gx = [_rand(g, (2, H, W, C), dev, 1.0, DT[dtype]) for _ in range(2)]
    prm = [_rand(g, (5, 5, 2, C2), dev, .2), 1 + _rand(g, (C2,), dev, .1),
           _rand(g, (C2,), dev, .1), _rand(g, (C2,), dev, .3),
           _rand(g, (3,), dev, .5)]
    _close(lgag_gate(*gx, *prm), lgag_gate_ref(*gx, *prm), dtype)


def test_wrappers_raise_on_unsupported_dtype(dev):
    x = torch.zeros((1, 4, 4, 8), device=dev, dtype=torch.float16)
    grid = torch.zeros((1, 8, 8, 4, 2), device=dev)
    with pytest.raises(TypeError):
        dysample_grid_sample(x, grid)


def test_gm_test_model_on_card_matches_cpu_and_counts_launches(dev):
    model = build_model(enc_name="gm_test")
    x = torch.randn((2, 64, 64, 1), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(x)
        model.to(dev)
        _build.reset_launch_counts()
        got = model(x.to(dev))
        torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    # 4 encoder + 7 decoder quad blocks; 7 CustomFfn (2 GEMMs + 2
    # stencils each); 3 DySample; 3 LGAG
    assert counts == {"quad_scan_ln": 11, "cffn_gemm": 14,
                      "cffn_dw3_gelu": 7, "cffn_inception7": 7,
                      "dysample_grid_sample": 3, "lgag_gate": 3}
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
