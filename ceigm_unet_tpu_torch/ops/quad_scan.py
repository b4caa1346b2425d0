"""Quad-group selective scan (d_state = 1) fused with the group LayerNorm.

Counterpart of ``ceigm_unet_tpu/ops/quad_scan.py`` ``sscan_quad_ln_cat``
(and of its batch-last twin ``sscan_quad_ln_cat_bl``): for channel group k,
scanned over the H*W pixels in direction ``directions[k]`` (1 row-major,
2 column-major, 3/4 those reversed),

    d = softplus(dt + bias);  h = exp(d*A)*h_prev + d*u*B;  y = C*h + D*u

then a LayerNorm over the group's D channels of each pixel (eps 1e-5), the
K groups lane-concatenated. Arithmetic is fp32; the output has u's dtype.

:func:`quad_scan_ln_cat` launches ``csrc/quad_scan_ln.cu`` for CUDA tensors
and runs :func:`quad_scan_ln_cat_ref` for CPU tensors.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ceigm_unet_tpu_torch.ops import _build

LN_EPS = 1e-5
MAX_D = 128          # csrc/quad_scan_ln.cu kMaxD


def scan_order(H: int, W: int, direction: int) -> torch.Tensor:
    """(H*W,) pixel index visited at each step of ``direction``."""
    L = H * W
    rm = torch.arange(L)
    cm = rm.reshape(H, W).t().reshape(-1)
    return {1: rm, 2: cm, 3: rm.flip(0), 4: cm.flip(0)}[int(direction)]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) in the overflow-free form jax.nn.softplus uses
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t*h_{t-1} + b_t along dim 2 in log2(L)
    vectorised doubling steps."""
    L = a.shape[2]
    s = 1
    while s < L:
        b = torch.cat([b[:, :, :s], b[:, :, s:] + a[:, :, s:] * b[:, :, :-s]],
                      dim=2)
        a = torch.cat([a[:, :, :s], a[:, :, s:] * a[:, :, :-s]], dim=2)
        s *= 2
    return b


def quad_scan_ln_cat_ref(u, dt, Bs, Cs, A, bias, Dv, ln_scale, ln_bias,
                         H: int, W: int, directions: Sequence[int]):
    """Plain PyTorch version of :func:`quad_scan_ln_cat`."""
    B, K, L, D = u.shape
    order = torch.stack([scan_order(H, W, d) for d in directions]).to(
        u.device)
    idx4 = order.view(1, K, L, 1).expand(B, K, L, D)
    idx3 = order.view(1, K, L).expand(B, K, L)
    prm = lambda t: t.float().reshape(1, K, 1, D)
    uf = torch.gather(u.float(), 2, idx4)
    dtf = torch.gather(dt.float(), 2, idx4)
    Bf = torch.gather(Bs.float(), 2, idx3).unsqueeze(-1)
    Cf = torch.gather(Cs.float(), 2, idx3).unsqueeze(-1)
    d = _softplus(dtf + prm(bias))
    h = _doubling_scan(torch.exp(d * prm(A)), d * uf * Bf)
    y = Cf * h + prm(Dv) * uf
    m = y.mean(-1, keepdim=True)
    var = (y * y).mean(-1, keepdim=True) - m * m
    yn = (y - m) * torch.rsqrt(var + LN_EPS) * prm(ln_scale) + prm(ln_bias)
    out = torch.empty_like(yn).scatter_(2, idx4, yn)       # pixel order
    return out.permute(0, 2, 1, 3).reshape(B, L, K * D).to(u.dtype)


def quad_scan_ln_cat(u, dt, Bs, Cs, A, bias, Dv, ln_scale, ln_bias,
                     H: int, W: int, directions: Sequence[int]):
    """u, dt: (B, K, H*W, D), any strides; Bs, Cs: (B, K, H*W) per-pixel
    scalars, all of one dtype; A, bias, Dv, ln_scale, ln_bias: (K, D).
    Returns the normalised activation (B, H*W, K*D) in u's dtype, pixel
    order."""
    B, K, L, D = u.shape
    if L != H * W or dt.shape != u.shape or Bs.shape != (B, K, L) \
            or Cs.shape != (B, K, L) or len(directions) != K:
        raise ValueError(f"quad_scan_ln_cat: shapes u {tuple(u.shape)} dt "
                         f"{tuple(dt.shape)} Bs {tuple(Bs.shape)} Cs "
                         f"{tuple(Cs.shape)} H*W {H * W} directions "
                         f"{tuple(directions)}")
    if not u.dtype == dt.dtype == Bs.dtype == Cs.dtype:
        raise TypeError("quad_scan_ln_cat: u, dt, Bs and Cs must share a "
                        "dtype")
    if u.device.type == "cpu":
        return quad_scan_ln_cat_ref(u, dt, Bs, Cs, A, bias, Dv, ln_scale,
                                    ln_bias, H, W, directions)
    if u.device.type != "cuda":
        raise ValueError(f"quad_scan_ln_cat: no kernel for {u.device}")
    if K > 4 or any(int(d) not in (1, 2, 3, 4) for d in directions):
        raise ValueError(f"quad_scan_ln_cat: directions {directions}")
    if D > MAX_D:
        raise ValueError(f"quad_scan_ln_cat: the kernel takes D <= {MAX_D}"
                         f" channels per group, got {D}")
    _build.check_cuda(u, dt, Bs, Cs)
    prm = [t.to(device=u.device, dtype=torch.float32).reshape(K, D)
           .contiguous() for t in (A, bias, Dv, ln_scale, ln_bias)]
    out = torch.empty((B, L, K * D), dtype=u.dtype, device=u.device)
    dirs = [int(d) for d in directions] + [1] * (4 - K)
    p = _build.ptr
    _build.launch(
        "quad_scan_ln", p(u), p(dt), p(Bs), p(Cs), *[p(t) for t in prm],
        p(out), *u.stride(), *dt.stride(), *Bs.stride(), *Cs.stride(),
        B, K, H, W, D, *dirs, _build.dtype_code(u))
    return out
