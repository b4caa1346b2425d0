"""Quad-group selective scan (d_state = 1) fused with the group LayerNorm,
and its backward.

Counterpart of ``ceigm_unet_tpu/ops/quad_scan.py`` ``sscan_quad_ln_cat``
(and of its batch-last twin ``sscan_quad_ln_cat_bl``): for channel group k,
scanned over the H*W pixels in direction ``directions[k]`` (1 row-major,
2 column-major, 3/4 those reversed),

    d = softplus(dt + bias);  h = exp(d*A)*h_prev + d*u*B;  y = C*h + D*u

then a LayerNorm over the group's D channels of each pixel (eps 1e-5), the
K groups lane-concatenated. Arithmetic is fp32; the output has u's dtype.

:func:`quad_scan_ln_cat` is the autograd op :class:`QuadScanLnCat`. Its
forward launches ``csrc/quad_scan_ln.cu`` for CUDA tensors and runs
:func:`quad_scan_ln_cat_ref` for CPU tensors. Its backward is the JAX
package's recompute design (``_quad_ln_bwd_impl``): h again by
:func:`scan2d`, the LayerNorm backward, then the scan's adjoint by
:func:`scan2d_adjoint`; both launch ``csrc/scan2d.cu`` for CUDA tensors and
run :func:`scan2d_ref` / :func:`scan2d_adjoint_ref` for CPU tensors.

:func:`quad_scan_ln_cat_q8` is the forward with u and dt stored as int8
(the JAX package's ``sscan_quad_ln_cat_q8``): the same kernel instantiated
for int8 operands, dequantized in its prologue, bf16 out; inference only.

:func:`sscan_dir` is the same scan without the LayerNorm, over all the
channels in every direction (the JAX package's ``sscan_dir``, the legacy
VMamba SS2D's scan), the autograd op :class:`SScanDir`: its forward
launches ``csrc/sscan_dir.cu`` for CUDA tensors and runs
:func:`sscan_dir_ref` for CPU tensors; its backward is the JAX package's
``_sscan_bwd`` (:func:`sscan_dir_bwd`), whose two scans are
:func:`scan2d` and :func:`scan2d_adjoint`, as in ``QuadScanLnCat``.
"""
from __future__ import annotations

import functools
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


def _orders(H: int, W: int, directions: Sequence[int],
            device) -> torch.Tensor:
    """(K, H*W) pixel index visited at each step, per group."""
    return torch.stack([scan_order(H, W, d) for d in directions]).to(device)


def scan2d_ref(a: torch.Tensor, b: torch.Tensor, H: int, W: int,
               directions: Sequence[int]) -> torch.Tensor:
    """Plain version of :func:`scan2d`."""
    B, K, L, D = a.shape
    idx = _orders(H, W, directions, a.device).view(1, K, L, 1).expand(
        B, K, L, D)
    h = _doubling_scan(torch.gather(a, 2, idx), torch.gather(b, 2, idx))
    return torch.empty_like(h).scatter_(2, idx, h)


def scan2d_adjoint_ref(a: torch.Tensor, gh: torch.Tensor, H: int, W: int,
                       directions: Sequence[int]) -> torch.Tensor:
    """Plain version of :func:`scan2d_adjoint`: the reversed walk, with a
    taken one step behind."""
    B, K, L, D = a.shape
    idx = _orders(H, W, directions, a.device).flip(1).view(1, K, L, 1) \
        .expand(B, K, L, D)
    ar = torch.gather(a, 2, idx)
    a_behind = torch.cat([torch.ones_like(ar[:, :, :1]), ar[:, :, :-1]], 2)
    g = _doubling_scan(a_behind, torch.gather(gh, 2, idx))
    return torch.empty_like(g).scatter_(2, idx, g)


def _scan2d_call(a, b, H: int, W: int, directions: Sequence[int],
                 adjoint: bool) -> torch.Tensor:
    B, K, L, D = a.shape
    what = "scan2d_adjoint" if adjoint else "scan2d"
    if L != H * W or b.shape != a.shape or len(directions) != K:
        raise ValueError(f"{what}: a {tuple(a.shape)} b {tuple(b.shape)} "
                         f"H*W {H * W} directions {tuple(directions)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{what}: takes float32, got {a.dtype}, {b.dtype}")
    # the kernel takes any strides over B, K and L and reads each pixel's
    # channels in one piece; the same layouts are refused on every device
    for name, t in (("a", a), ("b", b)):
        if D > 1 and t.stride(3) != 1:
            raise ValueError(f"{what}: {name} needs unit stride over D, got "
                             f"strides {t.stride()}")
    if a.device.type == "cpu":
        ref = scan2d_adjoint_ref if adjoint else scan2d_ref
        return ref(a, b, H, W, directions)
    if a.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {a.device}")
    if K > 4 or any(int(d) not in (1, 2, 3, 4) for d in directions):
        raise ValueError(f"{what}: directions {directions}")
    _build.check_cuda(a, b)
    out = torch.empty((B, K, L, D), dtype=torch.float32, device=a.device)
    dirs = [int(d) for d in directions] + [1] * (4 - K)
    p = _build.ptr
    _build.launch("scan2d", p(a), p(b), p(out), *a.stride()[:3],
                  *b.stride()[:3], B, K, H, W, D, *dirs, int(adjoint))
    return out


def scan2d(a: torch.Tensor, b: torch.Tensor, H: int, W: int,
           directions: Sequence[int]) -> torch.Tensor:
    """h_t = a_t*h_{t-1} + b_t along each group's direction (the JAX
    package's ``scan2d``, all K groups at once). a, b: (B, K, H*W, D) fp32
    in row-major pixel order, any strides over B, K and H*W and unit stride
    over D (others raise ValueError); h is returned contiguous, in the same
    order."""
    return _scan2d_call(a, b, H, W, directions, adjoint=False)


def scan2d_adjoint(a: torch.Tensor, gh: torch.Tensor, H: int, W: int,
                   directions: Sequence[int]) -> torch.Tensor:
    """The adjoint of :func:`scan2d`: g_t = gh_t + a_{t+1}*g_{t+1}, t in
    each group's direction order. Then da_t = g_t*h_{t-1} and db_t = g_t
    (the JAX package's ``_scan2d_bwd``)."""
    return _scan2d_call(a, gh, H, W, directions, adjoint=True)


@functools.lru_cache(maxsize=64)
def _behind_index(H: int, W: int, directions: tuple, device) -> torch.Tensor:
    """(K, H*W): for each pixel, the pixel its group's walk visits one step
    before it; H*W (a zero row) for the first."""
    order = _orders(H, W, directions, "cpu")
    behind = torch.full_like(order, H * W)
    behind.scatter_(1, order[:, 1:], order[:, :-1])
    return behind.to(device)


def _step_behind(h: torch.Tensor, H: int, W: int,
                 directions: Sequence[int]) -> torch.Tensor:
    """h_{t-1} at each pixel of (B, K, H*W, D) h, 0 at each walk's start."""
    B, K, L, D = h.shape
    hp = torch.cat([h, h.new_zeros(B, K, 1, D)], dim=2)
    idx = _behind_index(H, W, tuple(int(d) for d in directions), h.device)
    return torch.stack([hp[:, k].index_select(1, idx[k]) for k in range(K)],
                       dim=1)


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


def _quad_scan_ln_launch(u, dt, Bs, Cs, A, bias, Dv, ln_scale, ln_bias,
                        H: int, W: int, directions: Sequence[int],
                        scales=(), name: str = "quad_scan_ln"):
    """Launch K1 (``quad_scan_ln``: out in u's dtype) or, with the int8
    dequantization ``scales`` (su, sdt), its int8 form (``quad_scan_ln_q8``:
    out bf16)."""
    B, K, L, D = u.shape
    if u.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {u.device}")
    if K > 4 or any(int(d) not in (1, 2, 3, 4) for d in directions):
        raise ValueError(f"{name}: directions {directions}")
    if D > MAX_D:
        raise ValueError(f"{name}: the kernel takes D <= {MAX_D}"
                         f" channels per group, got {D}")
    _build.check_cuda(u, dt, Bs, Cs)
    prm = [t.to(device=u.device, dtype=torch.float32).reshape(K, D)
           .contiguous() for t in (A, bias, Dv, ln_scale, ln_bias, *scales)]
    out = torch.empty((B, L, K * D), dtype=torch.bfloat16 if scales
                      else u.dtype, device=u.device)
    dirs = [int(d) for d in directions] + [1] * (4 - K)
    p = _build.ptr
    _build.launch(
        name, p(u), p(dt), p(Bs), p(Cs), *[p(t) for t in prm],
        p(out), *u.stride(), *dt.stride(), *Bs.stride(), *Cs.stride(),
        B, K, H, W, D, *dirs, _build.dtype_code(Bs))
    return out


def quad_scan_ln_cat_bwd(u, dt, Bs, Cs, A, bias, Dv, ln_scale, ln_bias, go,
                         H: int, W: int, directions: Sequence[int]):
    """Gradients of :func:`quad_scan_ln_cat` for the output cotangent go
    (B, H*W, K*D): the JAX package's ``_quad_ln_bwd_impl``, formula for
    formula, all K groups at once, in fp32. Returns the grads of (u, dt,
    Bs, Cs, A, bias, Dv, ln_scale, ln_bias), each in its input's dtype and
    shape."""
    B, K, L, D = u.shape
    prm = lambda t: t.float().reshape(1, K, 1, D)
    mean = lambda t: t.mean(-1, keepdim=True)
    uf = u.float()
    Bf, Cf = Bs.float().unsqueeze(-1), Cs.float().unsqueeze(-1)
    g = go.float().reshape(B, L, K, D).permute(0, 2, 1, 3)
    Af, Dvf = prm(A), prm(Dv)

    pre = dt.float() + prm(bias)
    d = _softplus(pre)
    a = torch.exp(d * Af)
    h = scan2d(a, d * uf * Bf, H, W, directions)
    y = Cf * h + Dvf * uf

    mu = mean(y)
    ir = torch.rsqrt(mean(y * y) - mu * mu + LN_EPS)
    yn = (y - mu) * ir

    # affine backward
    dln_s = (g * yn).sum((0, 2))
    dln_b = g.sum((0, 2))
    dyn = g * prm(ln_scale)
    dy = ir * (dyn - mean(dyn) - yn * mean(dyn * yn))

    # y = C*h + D*u
    dCs = (h * dy).sum(-1)
    dDv = (uf * dy).sum((0, 2))
    db = scan2d_adjoint(a, Cf * dy, H, W, directions)
    da = db * _step_behind(h, H, W, directions)

    dd = db * uf * Bf + (da * a) * Af
    ddt = dd * torch.sigmoid(pre)
    du = db * d * Bf + Dvf * dy
    dBs = (db * d * uf).sum(-1)
    dA = (da * a * d).sum((0, 2))
    dbias = ddt.sum((0, 2))
    cast = lambda gr, t: gr.reshape(t.shape).to(t.dtype)
    return (cast(du, u), cast(ddt, dt), cast(dBs, Bs), cast(dCs, Cs),
            cast(dA, A), cast(dbias, bias), cast(dDv, Dv),
            cast(dln_s, ln_scale), cast(dln_b, ln_bias))


class QuadScanLnCat(torch.autograd.Function):
    """Autograd op of :func:`quad_scan_ln_cat`: saves its inputs, and
    recomputes in the backward (:func:`quad_scan_ln_cat_bwd`)."""

    @staticmethod
    def forward(ctx, u, dt, Bs, Cs, A, bias, Dv, ln_scale, ln_bias, H, W,
                directions):
        ctx.save_for_backward(u, dt, Bs, Cs, A, bias, Dv, ln_scale, ln_bias)
        ctx.geometry = (H, W, tuple(int(d) for d in directions))
        args = (u, dt, Bs, Cs, A, bias, Dv, ln_scale, ln_bias, H, W,
                directions)
        if u.device.type == "cpu":
            return quad_scan_ln_cat_ref(*args)
        return _quad_scan_ln_launch(*args)

    @staticmethod
    def backward(ctx, go):
        grads = quad_scan_ln_cat_bwd(*ctx.saved_tensors, go, *ctx.geometry)
        return (*grads, None, None, None)


def sscan_dir_ref(u, dt, Bs, Cs, A, bias, Dv, H: int, W: int,
                  directions: Sequence[int]) -> torch.Tensor:
    """Plain version of :func:`sscan_dir`: gather each direction's walk,
    doubling scan, scatter back to pixel order."""
    B, K, L, D = u.shape
    order = _orders(H, W, directions, u.device)
    idx4 = order.view(1, K, L, 1).expand(B, K, L, D)
    idx3 = order.view(1, K, L).expand(B, K, L)
    prm = lambda t: t.float().reshape(1, K, 1, D)
    uf = torch.gather(u.float(), 2, idx4)
    d = _softplus(torch.gather(dt.float(), 2, idx4) + prm(bias))
    Bf = torch.gather(Bs.float(), 2, idx3).unsqueeze(-1)
    Cf = torch.gather(Cs.float(), 2, idx3).unsqueeze(-1)
    h = _doubling_scan(torch.exp(d * prm(A)), d * uf * Bf)
    y = Cf * h + prm(Dv) * uf
    return torch.empty_like(y).scatter_(2, idx4, y)


def _sscan_dir_launch(u, dt, Bs, Cs, A, bias, Dv, H: int, W: int,
                      directions: Sequence[int]) -> torch.Tensor:
    """Launch K10 (``csrc/sscan_dir.cu``): y (B, K, H*W, D) fp32."""
    B, K, L, D = u.shape
    if u.device.type != "cuda":
        raise ValueError(f"sscan_dir: no kernel for {u.device}")
    if K > 4 or any(int(d) not in (1, 2, 3, 4) for d in directions):
        raise ValueError(f"sscan_dir: directions {directions}")
    _build.check_cuda(u, dt, Bs, Cs)
    prm = [t.to(device=u.device, dtype=torch.float32).reshape(K, D)
           .contiguous() for t in (A, bias, Dv)]
    out = torch.empty((B, K, L, D), dtype=torch.float32, device=u.device)
    dirs = [int(d) for d in directions] + [1] * (4 - K)
    p = _build.ptr
    _build.launch(
        "sscan_dir", p(u), p(dt), p(Bs), p(Cs), *[p(t) for t in prm], p(out),
        *u.stride(), *dt.stride(), *Bs.stride(), *Cs.stride(), B, K, H, W, D,
        *dirs, _build.dtype_code(u))
    return out


def sscan_dir_bwd(u, dt, Bs, Cs, A, bias, Dv, gy, H: int, W: int,
                  directions: Sequence[int]):
    """Gradients of :func:`sscan_dir` for the output cotangent gy (B, K,
    H*W, D): the JAX package's ``_sscan_bwd``, formula for formula, all K
    directions at once, in fp32. h again by :func:`scan2d`, the adjoint by
    :func:`scan2d_adjoint` (K8 twice on the card). Returns the grads of (u,
    dt, Bs, Cs, A, bias, Dv), each in its input's dtype and shape (du is
    (B, K, H*W, D) for a u expanded over K; autograd sums it back)."""
    B, K, L, D = u.shape
    prm = lambda t: t.float().reshape(1, K, 1, D)
    uf, g = u.float(), gy.float()
    Bf, Cf = Bs.float().unsqueeze(-1), Cs.float().unsqueeze(-1)
    Af = prm(A)

    pre = dt.float() + prm(bias)
    d = _softplus(pre)
    a = torch.exp(d * Af)
    h = scan2d(a, d * uf * Bf, H, W, directions)
    db = scan2d_adjoint(a, Cf * g, H, W, directions)
    da = db * _step_behind(h, H, W, directions)

    ddt = (db * uf * Bf + (da * a) * Af) * torch.sigmoid(pre)
    du = db * d * Bf + prm(Dv) * g
    dBs = (db * d * uf).sum(-1)
    dCs = (h * g).sum(-1)
    dA = (da * a * d).sum((0, 2))
    dbias = ddt.sum((0, 2))
    dDv = (g * uf).sum((0, 2))
    cast = lambda gr, t: gr.reshape(t.shape).to(t.dtype)
    return (cast(du, u), cast(ddt, dt), cast(dBs, Bs), cast(dCs, Cs),
            cast(dA, A), cast(dbias, bias), cast(dDv, Dv))


class SScanDir(torch.autograd.Function):
    """Autograd op of :func:`sscan_dir`: saves its inputs, and recomputes
    in the backward (:func:`sscan_dir_bwd`)."""

    @staticmethod
    def forward(ctx, u, dt, Bs, Cs, A, bias, Dv, H, W, directions):
        ctx.save_for_backward(u, dt, Bs, Cs, A, bias, Dv)
        ctx.geometry = (H, W, directions)
        args = (u, dt, Bs, Cs, A, bias, Dv, H, W, directions)
        if u.device.type == "cpu":
            return sscan_dir_ref(*args)
        return _sscan_dir_launch(*args)

    @staticmethod
    def backward(ctx, gy):
        grads = sscan_dir_bwd(*ctx.saved_tensors, gy, *ctx.geometry)
        return (*grads, None, None, None)


def sscan_dir(u, dt, Bs, Cs, A, bias, Dv, H: int, W: int,
              directions: Sequence[int]) -> torch.Tensor:
    """The d_state = 1 selective scan of each direction k of ``directions``
    over the H*W pixels (the JAX package's ``sscan_dir``, all K directions
    in one call): d = softplus(dt + bias), h = exp(d*A)*h_prev + d*u*Bs,
    y = Cs*h + Dv*u.

    u, dt: (B, K, H*W, D), any strides (u may be a stride-0 view over K);
    Bs, Cs: (B, K, H*W) per-pixel scalars; all of one dtype. A, bias, Dv:
    (K, D). Returns y (B, K, H*W, D) fp32 in row-major pixel order,
    differentiable in every tensor argument (:class:`SScanDir`). CUDA
    tensors launch ``csrc/sscan_dir.cu`` forward and ``csrc/scan2d.cu``
    twice backward; CPU tensors run the plain versions of both."""
    B, K, L, D = u.shape
    if L != H * W or dt.shape != u.shape or Bs.shape != (B, K, L) \
            or Cs.shape != (B, K, L) or len(directions) != K:
        raise ValueError(f"sscan_dir: shapes u {tuple(u.shape)} dt "
                         f"{tuple(dt.shape)} Bs {tuple(Bs.shape)} Cs "
                         f"{tuple(Cs.shape)} H*W {H * W} directions "
                         f"{tuple(directions)}")
    if not u.dtype == dt.dtype == Bs.dtype == Cs.dtype:
        raise TypeError("sscan_dir: u, dt, Bs and Cs must share a dtype")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sscan_dir: no kernel for {u.device}")
    return SScanDir.apply(u, dt, Bs, Cs, A, bias, Dv, H, W,
                          tuple(int(d) for d in directions))


def quad_scan_ln_cat(u, dt, Bs, Cs, A, bias, Dv, ln_scale, ln_bias,
                     H: int, W: int, directions: Sequence[int]):
    """u, dt: (B, K, H*W, D), any strides; Bs, Cs: (B, K, H*W) per-pixel
    scalars, all of one dtype; A, bias, Dv, ln_scale, ln_bias: (K, D).
    Returns the normalised activation (B, H*W, K*D) in u's dtype, pixel
    order, differentiable in every tensor argument."""
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
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quad_scan_ln_cat: no kernel for {u.device}")
    return QuadScanLnCat.apply(u, dt, Bs, Cs, A, bias, Dv, ln_scale,
                               ln_bias, H, W, tuple(directions))


def quad_scan_ln_cat_q8_ref(u_q, dt_q, su, sdt, Bs, Cs, A, bias, Dv,
                            ln_scale, ln_bias, H: int, W: int,
                            directions: Sequence[int]):
    """Plain version of :func:`quad_scan_ln_cat_q8`: dequantize, run
    :func:`quad_scan_ln_cat_ref`, round to bf16."""
    K, D = u_q.shape[1], u_q.shape[3]
    deq = lambda q, s: q.float() * s.float().reshape(1, K, 1, D)
    return quad_scan_ln_cat_ref(
        deq(u_q, su), deq(dt_q, sdt), Bs, Cs, A, bias, Dv, ln_scale, ln_bias,
        H, W, directions).to(torch.bfloat16)


def quad_scan_ln_cat_q8(u_q, dt_q, su, sdt, Bs, Cs, A, bias, Dv, ln_scale,
                        ln_bias, H: int, W: int, directions: Sequence[int]):
    """:func:`quad_scan_ln_cat` with u and dt stored as int8 (the JAX
    package's ``sscan_quad_ln_cat_q8``): u_q, dt_q (B, K, H*W, D) int8, any
    strides; su, sdt (K, D) their dequantization scales (u = u_q * su);
    Bs, Cs (B, K, H*W) fp32 or bf16. Returns (B, H*W, K*D) in bf16. CUDA
    tensors launch ``csrc/quad_scan_ln.cu``'s int8 form, CPU tensors run
    :func:`quad_scan_ln_cat_q8_ref`. Forward only: inputs that require
    grad raise NotImplementedError."""
    B, K, L, D = u_q.shape
    if L != H * W or dt_q.shape != u_q.shape or Bs.shape != (B, K, L) \
            or Cs.shape != (B, K, L) or len(directions) != K \
            or su.shape != (K, D) or sdt.shape != (K, D):
        raise ValueError(f"quad_scan_ln_cat_q8: shapes u_q {tuple(u_q.shape)}"
                         f" dt_q {tuple(dt_q.shape)} su {tuple(su.shape)} "
                         f"sdt {tuple(sdt.shape)} Bs {tuple(Bs.shape)} Cs "
                         f"{tuple(Cs.shape)} H*W {H * W} directions "
                         f"{tuple(directions)}")
    if u_q.dtype != torch.int8 or dt_q.dtype != torch.int8 \
            or Bs.dtype != Cs.dtype:
        raise TypeError(f"quad_scan_ln_cat_q8: u_q {u_q.dtype}, dt_q "
                        f"{dt_q.dtype} must be int8 and Bs {Bs.dtype}, Cs "
                        f"{Cs.dtype} share a dtype")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (su, sdt, Bs, Cs, A, bias, Dv,
                                      ln_scale, ln_bias)):
        raise NotImplementedError(
            "quad_scan_ln_cat_q8: int8 storage of u and dt is inference-only "
            "(int8 rounding has no gradient); run it under torch.no_grad(), "
            "or build the model with quant_scan=False to train")
    args = (u_q, dt_q, su, sdt, Bs, Cs, A, bias, Dv, ln_scale, ln_bias, H, W,
            directions)
    if u_q.device.type == "cpu":
        return quad_scan_ln_cat_q8_ref(*args)
    return _quad_scan_ln_launch(u_q, dt_q, Bs, Cs, A, bias, Dv, ln_scale,
                                ln_bias, H, W, directions, scales=(su, sdt),
                                name="quad_scan_ln_q8")
