"""CustomFfn: fc1 -> depthwise 3x3 -> GELU -> inception mixer -> fc2.

Counterpart of ``ceigm_unet_tpu/ops/ffn_pallas.py``: :func:`custom_ffn_fused`
keeps the argument layout of the JAX entry point (flax kernel layouts:
w1 (C, HID), dwk (3, 3, 1, HID), inck (7, 7, 1, HID), w2 (HID, C)). For
CUDA tensors it runs the kernels of ``csrc/cffn.cu`` through
:func:`ffn_gemm` (fc1, fc2), :func:`dw3_gelu` and :func:`inception7`, with an
fp32 hidden; for CPU tensors it runs :func:`custom_ffn_fused_ref`, the port of
``_cffn_ref``. Each of the three wrappers also has its own plain version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ceigm_unet_tpu_torch.ops import _build
from ceigm_unet_tpu_torch.ops.activations import gelu


def inception_composite(c: int, g: int, p3k, p5k, p7k, p3b, p5b, p7b,
                        dtype: torch.dtype):
    """Composite (7, 7, 1, c) depthwise kernel + (c,) bias implementing
    InceptionDWConv2d_MultiScale's split (identity on the first c-3g
    channels, centred 3x3/5x5/7x7 on the rest) as one depthwise pass."""
    dev = p3k.device
    K = torch.zeros((7, 7, 1, c), dtype=dtype, device=dev)
    K[3, 3, :, :c - 3 * g] = 1.0
    K[2:5, 2:5, :, c - 3 * g:c - 2 * g] = p3k.to(dtype)
    K[1:6, 1:6, :, c - 2 * g:c - g] = p5k.to(dtype)
    K[:, :, :, c - g:] = p7k.to(dtype)
    bias = torch.cat([torch.zeros(c - 3 * g, dtype=dtype, device=dev),
                      p3b.to(dtype), p5b.to(dtype), p7b.to(dtype)])
    return K, bias


def depthwise_nhwc(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Depthwise 'same' conv of NHWC x with a flax (kh, kw, 1, C) kernel,
    in x's dtype."""
    kh = k.shape[0]
    w = k.to(x.dtype).permute(3, 2, 0, 1)                # (C, 1, kh, kw)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=kh // 2,
                 groups=x.shape[-1])
    return y.permute(0, 2, 3, 1)


def custom_ffn_fused_ref(x, w1, b1, dwk, dwb, inck, incb, w2, b2, H: int,
                         W: int, n_tap: int = 0):
    """Plain PyTorch version (port of ``_cffn_ref``); ``n_tap`` only
    selects a kernel shortcut and does not change the result."""
    B, L, C = x.shape
    dt = x.dtype
    h = x @ w1.to(dt) + b1.to(dt)
    hc = depthwise_nhwc(h.reshape(B, H, W, -1), dwk)
    q = gelu((hc + dwb.to(hc.dtype)).float())
    q = q + depthwise_nhwc(q, inck.float()) + incb.float()
    o = q.reshape(B, L, -1).to(dt) @ w2.to(dt)
    return (o + b2.to(dt)).to(dt)


def ffn_gemm_ref(a, w, bias, out_dtype: torch.dtype):
    """Plain version of :func:`ffn_gemm`: a rounded to w's dtype, fp32
    product and bias, one rounding to ``out_dtype``."""
    return (a.to(w.dtype).float() @ w.float() + bias.float()).to(out_dtype)


def ffn_gemm(a, w, bias, out_dtype: torch.dtype):
    """(M, K) @ (K, N) + bias (N,) -> (M, N) in ``out_dtype``, fp32
    accumulation; a is rounded to w's dtype first (fc2 takes the fp32
    hidden in the compute dtype, as the TPU kernel does)."""
    (M, K), N = a.shape, w.shape[1]
    if w.shape[0] != K or bias.shape != (N,):
        raise ValueError(f"ffn_gemm: a {tuple(a.shape)} w {tuple(w.shape)} "
                         f"bias {tuple(bias.shape)}")
    if (a.dtype, out_dtype) not in ((w.dtype, torch.float32),
                                    (torch.float32, w.dtype)):
        raise TypeError(f"ffn_gemm: a {a.dtype} / w {w.dtype} -> "
                        f"{out_dtype}: the kernel takes fc1 (a in w's dtype, "
                        f"fp32 out) or fc2 (fp32 a, out in w's dtype)")
    if a.device.type == "cpu":
        return ffn_gemm_ref(a, w, bias, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"ffn_gemm: no kernel for {a.device}")
    ac, wc = a.contiguous(), w.contiguous()
    bf = bias.to(device=a.device, dtype=torch.float32).contiguous()
    _build.check_cuda(ac, wc, bf)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    p = _build.ptr
    _build.launch("cffn_gemm", p(ac), p(wc), p(bf), p(out), M, N, K,
                  _build.dtype_code(ac), _build.dtype_code(wc),
                  _build.dtype_code(out))
    return out


def dw3_gelu_ref(h, dwk, dwb, H: int, W: int):
    """Plain version of :func:`dw3_gelu`."""
    B = h.shape[0] // (H * W)
    q = gelu(depthwise_nhwc(h.reshape(B, H, W, -1), dwk.float()) + dwb)
    return q.reshape(h.shape)


def dw3_gelu(h, dwk, dwb, H: int, W: int):
    """gelu(depthwise3x3(h) + dwb) of the fp32 hidden h (B*H*W, HID);
    dwk (3, 3, 1, HID)."""
    M, HID = h.shape
    if h.dtype != torch.float32 or M % (H * W) or dwk.numel() != 9 * HID:
        raise ValueError(f"dw3_gelu: h {tuple(h.shape)} {h.dtype} H*W "
                         f"{H * W} dwk {tuple(dwk.shape)}")
    if h.device.type == "cpu":
        return dw3_gelu_ref(h, dwk, dwb, H, W)
    if h.device.type != "cuda":
        raise ValueError(f"dw3_gelu: no kernel for {h.device}")
    hc = h.contiguous()
    kf, bf = [t.to(device=h.device, dtype=torch.float32).reshape(
        -1, HID).contiguous() for t in (dwk, dwb)]
    _build.check_cuda(hc, kf, bf)
    q = torch.empty_like(hc)
    p = _build.ptr
    _build.launch("cffn_dw3_gelu", p(hc), p(kf), p(bf), p(q), M // (H * W),
                  H, W, HID)
    return q


def inception7_ref(q, inck, incb, H: int, W: int, n_id: int = 0):
    """Plain version of :func:`inception7` (``n_id`` only selects a kernel
    shortcut)."""
    B = q.shape[0] // (H * W)
    q4 = q.reshape(B, H, W, -1)
    return (q4 + depthwise_nhwc(q4, inck.float()) + incb).reshape(q.shape)


def inception7(q, inck, incb, H: int, W: int, n_id: int = 0):
    """q + composite7x7(q) + incb of the fp32 hidden q (B*H*W, HID); the
    first ``n_id`` channels are the composite's identity channels."""
    M, HID = q.shape
    if q.dtype != torch.float32 or M % (H * W) or inck.numel() != 49 * HID:
        raise ValueError(f"inception7: q {tuple(q.shape)} {q.dtype} H*W "
                         f"{H * W} inck {tuple(inck.shape)}")
    if q.device.type == "cpu":
        return inception7_ref(q, inck, incb, H, W, n_id)
    if q.device.type != "cuda":
        raise ValueError(f"inception7: no kernel for {q.device}")
    qc = q.contiguous()
    kf, bf = [t.to(device=q.device, dtype=torch.float32).reshape(
        -1, HID).contiguous() for t in (inck, incb)]
    _build.check_cuda(qc, kf, bf)
    out = torch.empty_like(qc)
    p = _build.ptr
    _build.launch("cffn_inception7", p(qc), p(kf), p(bf), p(out),
                  M // (H * W), H, W, HID, n_id)
    return out


def custom_ffn_fused(x, w1, b1, dwk, dwb, inck, incb, w2, b2, H: int,
                     W: int, n_tap: int = 0):
    """x (B, H*W, C) -> (B, H*W, C). ``n_tap``: number of non-identity
    channels of the composite (3 * HID/8, the tail of the hidden); the
    kernel runs the 49 taps only there. 0 taps every channel. On a card:
    :func:`ffn_gemm` -> :func:`dw3_gelu` -> :func:`inception7` ->
    :func:`ffn_gemm`, with the hidden in fp32."""
    B, L, C = x.shape
    HID = w1.shape[1]
    if L != H * W or tuple(w1.shape) != (C, HID) \
            or tuple(w2.shape) != (HID, C) or not 0 <= n_tap <= HID:
        raise ValueError(f"custom_ffn_fused: x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w2 {tuple(w2.shape)} H*W "
                         f"{H * W} n_tap {n_tap}")
    if x.device.type == "cpu":
        return custom_ffn_fused_ref(x, w1, b1, dwk, dwb, inck, incb, w2, b2,
                                    H, W, n_tap)
    dt = x.dtype
    h = ffn_gemm(x.reshape(B * L, C), w1.to(dt), b1, torch.float32)
    q = inception7(dw3_gelu(h, dwk, dwb, H, W), inck, incb, H, W,
                   HID - n_tap if n_tap else 0)
    return ffn_gemm(q, w2.to(dt), b2, dt).view(B, L, C)
