"""CustomFfn: fc1 -> depthwise 3x3 -> GELU -> inception mixer -> fc2.

Counterpart of ``ceigm_unet_tpu/ops/ffn_pallas.py``: :func:`custom_ffn_fused`
keeps the argument layout of the JAX entry point (flax kernel layouts:
w1 (C, HID), dwk (3, 3, 1, HID), inck (7, 7, 1, HID), w2 (HID, C)). For
CUDA tensors it runs the kernels of ``csrc/cffn_gemm.cu`` (:func:`ffn_gemm`,
fc1 and fc2) and ``csrc/cffn.cu`` (:func:`dw3_gelu_inception7`, the
depthwise 3x3, GELU and inception stencil between them), with an fp32
hidden; for CPU tensors it runs :func:`custom_ffn_fused_ref`, the port of
``_cffn_ref``. Each of the two wrappers also has its own plain version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ceigm_unet_tpu_torch.ops import _build
from ceigm_unet_tpu_torch.ops.activations import gelu
from ceigm_unet_tpu_torch.ops.recompute import recompute_vjp


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


def gemm_operands(a, w):
    """a (M, K) and w (K, N) as the GEMM kernels load them: a (M, Kp) and
    w's transpose (N, Kp), K-major, each contiguous and 16-byte aligned,
    with Kp = K rounded up to whole 16 bytes of w's dtype (8 bf16 for the
    bf16 route's TMA row pitches, 4 fp32 for the fp32 route's float4 loads)
    and zeros in the added columns. An operand that already fits is passed
    as it is: nn.Linear's weight is (N, K) storage, so ``fc.weight.t()``
    comes back as that storage without a copy."""
    K = a.shape[1]
    q = 16 // w.element_size()
    Kp = -(-K // q) * q

    def fit(t):
        if t.shape[1] != Kp:
            return F.pad(t, (0, Kp - K))
        if not t.is_contiguous() or t.data_ptr() % 16:
            return t.clone(memory_format=torch.contiguous_format)
        return t
    return fit(a), fit(w.t())


def ffn_gemm(a, w, bias, out_dtype: torch.dtype):
    """(M, K) @ (K, N) + bias (N,) -> (M, N) in ``out_dtype``, fp32
    accumulation; a is rounded to w's dtype first (fc2 takes the fp32
    hidden in the compute dtype, as the TPU kernel does). On a card, the
    operands go through :func:`gemm_operands` to the kernel of w's dtype:
    bf16 weights to the TMA/wgmma kernel, fp32 weights to the fp32 FMA
    kernel (fp32 products and sums throughout)."""
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
    _build.check_no_grad("ffn_gemm", a, w, bias)
    ac, wc = gemm_operands(a, w)
    bf = bias.to(device=a.device, dtype=torch.float32).contiguous()
    _build.check_cuda(ac, wc, bf)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    p = _build.ptr
    _build.launch("cffn_gemm", p(ac), p(wc), p(bf), p(out), M, N,
                  ac.shape[1], _build.dtype_code(ac), _build.dtype_code(wc),
                  _build.dtype_code(out))
    return out


def dw3_gelu_ref(h, dwk, dwb, H: int, W: int):
    """gelu(depthwise3x3(h) + dwb) of the fp32 hidden h (B*H*W, HID); dwk
    (3, 3, 1, HID). The first half of :func:`dw3_gelu_inception7_ref`."""
    B = h.shape[0] // (H * W)
    q = gelu(depthwise_nhwc(h.reshape(B, H, W, -1), dwk.float()) + dwb)
    return q.reshape(h.shape)


def inception7_ref(q, inck, incb, H: int, W: int, n_id: int = 0):
    """q + composite7x7(q) + incb of the fp32 hidden q (B*H*W, HID); inck
    (7, 7, 1, HID). The second half of :func:`dw3_gelu_inception7_ref`
    (``n_id`` only selects a kernel shortcut)."""
    B = q.shape[0] // (H * W)
    q4 = q.reshape(B, H, W, -1)
    return (q4 + depthwise_nhwc(q4, inck.float()) + incb).reshape(q.shape)


def dw3_gelu_inception7_ref(h, dwk, dwb, inck, incb, H: int, W: int,
                            n_id: int = 0):
    """Plain version of :func:`dw3_gelu_inception7`: :func:`inception7_ref`
    of :func:`dw3_gelu_ref`."""
    return inception7_ref(dw3_gelu_ref(h, dwk, dwb, H, W), inck, incb, H, W,
                          n_id)


def dw3_gelu_inception7(h, dwk, dwb, inck, incb, H: int, W: int,
                        n_id: int = 0):
    """q + composite7x7(q) + incb with q = gelu(depthwise3x3(h) + dwb), of
    the fp32 hidden h (B*H*W, HID) that fc1 writes; dwk (3, 3, 1, HID),
    inck (7, 7, 1, HID). The first ``n_id`` channels are the composite's
    identity channels. On a card one kernel, which keeps q out of device
    memory."""
    M, HID = h.shape
    if (h.dtype != torch.float32 or M % (H * W) or dwk.numel() != 9 * HID
            or inck.numel() != 49 * HID or dwb.numel() != HID
            or incb.numel() != HID or not 0 <= n_id <= HID):
        raise ValueError(f"dw3_gelu_inception7: h {tuple(h.shape)} {h.dtype} "
                         f"H*W {H * W} dwk {tuple(dwk.shape)} inck "
                         f"{tuple(inck.shape)} n_id {n_id}")
    if h.device.type == "cpu":
        return dw3_gelu_inception7_ref(h, dwk, dwb, inck, incb, H, W, n_id)
    if h.device.type != "cuda":
        raise ValueError(f"dw3_gelu_inception7: no kernel for {h.device}")
    _build.check_no_grad("dw3_gelu_inception7", h, dwk, dwb, inck, incb)
    hc = h.contiguous()
    prm = [t.to(device=h.device, dtype=torch.float32).reshape(
        -1, HID).contiguous() for t in (dwk, dwb, inck, incb)]
    _build.check_cuda(hc, *prm)
    out = torch.empty_like(hc)
    p = _build.ptr
    _build.launch("cffn_dw3_inception7", p(hc), *[p(t) for t in prm],
                  p(out), M // (H * W), H, W, HID, n_id)
    return out


def custom_ffn_fused_bwd(x, w1, b1, dwk, dwb, inck, incb, w2, b2, go,
                         H: int, W: int, needs_grad=(True,) * 9):
    """Grads of :func:`custom_ffn_fused` for cotangent go (B, H*W, C): the
    vector-Jacobian product of :func:`custom_ffn_fused_ref`, recomputed.
    One entry per tensor argument (None where ``needs_grad`` is False)."""
    return recompute_vjp(
        lambda *a: custom_ffn_fused_ref(*a, H, W),
        (x, w1, b1, dwk, dwb, inck, incb, w2, b2), needs_grad, go)


class CustomFfnFused(torch.autograd.Function):
    """Autograd op of :func:`custom_ffn_fused`."""

    @staticmethod
    def forward(ctx, x, w1, b1, dwk, dwb, inck, incb, w2, b2, H, W, n_tap):
        ctx.save_for_backward(x, w1, b1, dwk, dwb, inck, incb, w2, b2)
        ctx.hw = (H, W)
        if x.device.type == "cpu":
            return custom_ffn_fused_ref(x, w1, b1, dwk, dwb, inck, incb, w2,
                                        b2, H, W, n_tap)
        B, L, C = x.shape
        HID = w1.shape[1]
        dt = x.dtype
        h = ffn_gemm(x.reshape(B * L, C), w1.to(dt), b1, torch.float32)
        q = dw3_gelu_inception7(h, dwk, dwb, inck, incb, H, W,
                                HID - n_tap if n_tap else 0)
        return ffn_gemm(q, w2.to(dt), b2, dt).view(B, L, C)

    @staticmethod
    def backward(ctx, go):
        grads = custom_ffn_fused_bwd(*ctx.saved_tensors, go, *ctx.hw,
                                     needs_grad=ctx.needs_input_grad[:9])
        return (*grads, None, None, None)


def custom_ffn_fused(x, w1, b1, dwk, dwb, inck, incb, w2, b2, H: int,
                     W: int, n_tap: int = 0):
    """x (B, H*W, C) -> (B, H*W, C). ``n_tap``: number of non-identity
    channels of the composite (3 * HID/8, the tail of the hidden); the
    kernel runs the 49 taps only there. 0 taps every channel. On a card:
    :func:`ffn_gemm` -> :func:`dw3_gelu_inception7` -> :func:`ffn_gemm`,
    with the hidden in fp32."""
    B, L, C = x.shape
    HID = w1.shape[1]
    if L != H * W or tuple(w1.shape) != (C, HID) \
            or tuple(w2.shape) != (HID, C) or not 0 <= n_tap <= HID:
        raise ValueError(f"custom_ffn_fused: x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w2 {tuple(w2.shape)} H*W "
                         f"{H * W} n_tap {n_tap}")
    return CustomFfnFused.apply(x, w1, b1, dwk, dwb, inck, incb, w2, b2, H,
                                W, n_tap)
