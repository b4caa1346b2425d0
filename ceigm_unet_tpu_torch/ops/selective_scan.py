"""Selective scan (Mamba S6) with the reference CUDA extension's API.

Counterpart of ``ceigm_unet_tpu/ops/selective_scan.py`` ``selective_scan``
and of the two kernels of its ``pallas`` backend (``ops/scan_pallas.py``):

    a_t = exp(delta_t * A)            # (dim, N)
    b_t = delta_t * u_t * B_t
    h_t = a_t * h_{t-1} + b_t
    y_t = sum_n C_{n,t} * h_{n,t} + D * u_t

u, delta: (batch, dim, L); A: (dim, N); B, C: (batch, G, N, L), or
(batch, N, L) for G = 1; D, delta_bias: (dim,) or None. Arithmetic is fp32
whatever the input dtype.

Routing (in place of ``_resolve_backend``): N = 1 with softplus goes to
:func:`selective_scan_n1`, the fused scan (K12); every other case,
``return_last_state`` included (it needs h), builds the fp32 scan elements
in PyTorch and runs :func:`scan_rows` (K11). Both launch
``csrc/scan_rows.cu`` for CUDA tensors and run their plain versions for CPU
tensors; they are raw forward ops, which refuse inputs that require grad
on the card.

:func:`selective_scan` is the autograd op :class:`SelectiveScan` on either
route: its backward is the JAX package's recompute rule (``_bwd_rule``,
:func:`selective_scan_bwd`), two :func:`scan_rows` launches, on the CPU as
on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from ceigm_unet_tpu_torch.ops import _build
from ceigm_unet_tpu_torch.ops.quad_scan import _softplus


def _bc4(x: torch.Tensor) -> torch.Tensor:
    """(batch, N, L) -> (batch, 1, N, L); 4-D passes through."""
    return x[:, None] if x.dim() == 3 else x


def scan_rows_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`scan_rows`: log2(L) vectorised doubling
    steps along the last axis."""
    L = a.shape[-1]
    s = 1
    while s < L:
        b = torch.cat([b[..., :s], b[..., s:] + a[..., s:] * b[..., :-s]],
                      dim=-1)
        a = torch.cat([a[..., :s], a[..., s:] * a[..., :-s]], dim=-1)
        s *= 2
    return b


def scan_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t*h_{t-1} + b_t, h_{-1} = 0, along the last axis of fp32
    (..., L) tensors (the JAX package's ``scan_pallas``)."""
    if a.shape != b.shape:
        raise ValueError(f"scan_rows: a {tuple(a.shape)} b {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"scan_rows: takes float32, got {a.dtype}, "
                        f"{b.dtype}")
    if a.device.type == "cpu":
        return scan_rows_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"scan_rows: no kernel for {a.device}")
    _build.check_no_grad("scan_rows", a, b)
    L = a.shape[-1]
    a2, b2 = a.reshape(-1, L).contiguous(), b.reshape(-1, L).contiguous()
    _build.check_cuda(a2, b2)
    out = torch.empty_like(a2)
    p = _build.ptr
    _build.launch("scan_rows", p(a2), p(b2), p(out), a2.shape[0], L)
    return out.view(a.shape)


def _check_n1(u, delta, A, B4, C4, D, delta_bias):
    batch, dim, L = u.shape
    G = B4.shape[1]
    opt = {"D": D, "delta_bias": delta_bias}
    if delta.shape != u.shape or A.shape != (dim, 1) \
            or B4.shape != (batch, G, 1, L) or C4.shape != B4.shape \
            or dim % G or any(t is not None and t.shape != (dim,)
                              for t in opt.values()):
        shapes = {"u": u, "delta": delta, "A": A, "B": B4, "C": C4, **opt}
        raise ValueError("selective_scan_n1: " + " ".join(
            f"{k} {None if t is None else tuple(t.shape)}"
            for k, t in shapes.items()))
    return batch, dim, G, L


def selective_scan_n1_ref(u, delta, A, B, C, D=None, delta_bias=None,
                          out_dtype=None) -> torch.Tensor:
    """Plain version of :func:`selective_scan_n1`."""
    B4, C4 = _bc4(B), _bc4(C)
    batch, dim, G, L = _check_n1(u, delta, A, B4, C4, D, delta_bias)
    grp = lambda t: t.reshape(batch, G, dim // G, L)
    x = delta.float()
    if delta_bias is not None:
        x = x + delta_bias.float()[:, None]
    d = grp(_softplus(x))
    uf = grp(u.float())
    h = scan_rows_ref(torch.exp(d * A.float().reshape(G, dim // G, 1)),
                      d * uf * B4.float())
    y = C4.float() * h
    if D is not None:
        y = y + D.float().reshape(G, dim // G, 1) * uf
    return y.reshape(batch, dim, L).to(out_dtype or u.dtype)


def selective_scan_n1(u, delta, A, B, C, D=None, delta_bias=None,
                      out_dtype=None) -> torch.Tensor:
    """The fused d_state = 1 selective scan with softplus (the JAX
    package's ``selective_scan_fused_n1``): one pass over the (batch*dim,
    L) rows, B and C read per (batch, group). A: (dim, 1). Returns y
    (batch, dim, L) in ``out_dtype`` (None: u's dtype)."""
    B4, C4 = _bc4(B), _bc4(C)
    batch, dim, G, L = _check_n1(u, delta, A, B4, C4, D, delta_bias)
    out_dtype = out_dtype or u.dtype
    if u.device.type == "cpu":
        return selective_scan_n1_ref(u, delta, A, B4, C4, D, delta_bias,
                                     out_dtype)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan_n1: no kernel for {u.device}")
    opt = [t for t in (D, delta_bias) if t is not None]
    _build.check_no_grad("selective_scan_n1", u, delta, A, B4, C4, *opt)
    # the kernel reads u, delta, B and C in their own dtype (fp32 or bf16;
    # B and C in one) with unit stride along L, through their (batch, dim)
    # and (batch, group) strides, A's column through its stride, and takes
    # a null pointer for an absent D or delta_bias: a call on such inputs
    # allocates y and nothing else
    uk, dk = _rows(u), _rows(delta)
    Bk, Ck = _rows(B4[:, :, 0]), _rows(C4[:, :, 0])
    if Bk.dtype != Ck.dtype:
        Bk, Ck = Bk.float(), Ck.float()
    Ak = A[:, 0].float()
    prm = [None if t is None else t.float().contiguous()
           for t in (delta_bias, D)]
    _build.check_cuda(uk, dk, Bk, Ck, Ak, *[t for t in prm if t is not None])
    odt = out_dtype if out_dtype in _build.DTYPE_CODES else torch.float32
    out = torch.empty((batch, dim, L), dtype=odt, device=u.device)
    p, code = _build.ptr, _build.dtype_code
    _build.launch("selective_scan_n1", p(uk), p(dk), p(Bk), p(Ck), p(Ak),
                  *[None if t is None else p(t) for t in prm], p(out),
                  *uk.stride()[:2], *dk.stride()[:2], *Bk.stride()[:2],
                  *Ck.stride()[:2], Ak.stride(0), batch, dim, G, L,
                  code(uk), code(dk), code(Bk), code(out))
    return out.to(out_dtype)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as the K12 kernel reads it: fp32 or bf16, unit stride along L (a
    view of t where it already is)."""
    if t.dtype not in _build.DTYPE_CODES:
        t = t.float()
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def _prep(u, delta, A, B4, delta_bias, delta_softplus: bool):
    """fp32 u and step size (bias added, softplus applied when set), and
    the scan elements a = exp(dt*A), b = dt*u*B: (batch, dim, N, L)."""
    batch, dim, L = u.shape
    G, N = B4.shape[1], A.shape[-1]
    uf, dt = u.float(), delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()[:, None]
    if delta_softplus:
        dt = _softplus(dt)
    a = torch.exp(dt[:, :, None, :] * A.float()[None, :, :, None])
    b = ((dt * uf).reshape(batch, G, dim // G, 1, L)
         * B4.float()[:, :, None]).reshape(batch, dim, N, L)
    return uf, dt, a, b


def _rows_forward(u, delta, A, B4, C4, D, delta_bias, delta_softplus: bool,
                  out_dtype):
    """The unfused route: fp32 scan elements in PyTorch, :func:`scan_rows`
    (K11), the C contraction. Returns (y, h)."""
    batch, dim, L = u.shape
    G, N = B4.shape[1], A.shape[-1]
    uf, _, a, b = _prep(u, delta, A, B4, delta_bias, delta_softplus)
    h = scan_rows(a, b)                                  # (batch, dim, N, L)
    y = torch.einsum("bgdnl,bgnl->bgdl", h.reshape(batch, G, dim // G, N, L),
                     C4.float()).reshape(batch, dim, L)
    if D is not None:
        y = y + D.float()[None, :, None] * uf
    return y.to(out_dtype), h


def selective_scan_bwd(u, delta, A, B, C, D, delta_bias, gy,
                       delta_softplus: bool, gh_last=None):
    """Gradients of :func:`selective_scan` for the output cotangent gy
    (batch, dim, L), and for the last state's ``gh_last`` (batch, dim, N)
    with ``return_last_state``: the JAX package's ``_bwd_rule``, formula for
    formula, with exactly two :func:`scan_rows` launches (h again; the
    reversed adjoint over a_{t+1}, seeded at t = L-1 with gh_last). Returns
    the grads of (u, delta, A, B, C, D, delta_bias), each in its input's
    dtype and shape; None for a None input."""
    B4, C4 = _bc4(B), _bc4(C)
    batch, dim, L = u.shape
    G, N = B4.shape[1], A.shape[-1]
    dg = dim // G
    Af, Bf, Cf = A.float(), B4.float(), C4.float()
    gyf = gy.float()
    uf, dt, a, b = _prep(u, delta, A, B4, delta_bias, delta_softplus)
    h = scan_rows(a, b)                                  # (batch, dim, N, L)

    # y_t = sum_{d in g} C_{g,n,t} h_{d,n,t} (+ D u)
    hg = h.reshape(batch, G, dg, N, L)
    gyg = gyf.reshape(batch, G, dg, L)
    dC = torch.einsum("bgdnl,bgdl->bgnl", hg, gyg)

    # adjoint g_t = C_t gy_t + a_{t+1} g_{t+1}, walked in reverse
    bt = (Cf[:, :, None] * gyg[:, :, :, None]).reshape(batch, dim, N, L)
    if gh_last is not None:
        bt[..., -1] += gh_last.float()
    a_next = torch.cat([a[..., 1:], torch.ones_like(a[..., :1])], dim=-1)
    g = scan_rows(a_next.flip(-1), bt.flip(-1)).flip(-1)
    h_prev = torch.cat([torch.zeros_like(h[..., :1]), h[..., :-1]], dim=-1)
    da_a = g * h_prev * a

    ddt_a = torch.einsum("bdnl,dn->bdl", da_a, Af)
    dA = torch.einsum("bdnl,bdl->dn", da_a, dt)
    dbg = g.reshape(batch, G, dg, N, L)
    dB = torch.einsum("bgdnl,bgdl->bgnl", dbg,
                      (dt * uf).reshape(batch, G, dg, L))
    du_b = torch.einsum("bgdnl,bgnl->bgdl", dbg, Bf).reshape(batch, dim, L)
    du = du_b * dt
    ddt = ddt_a + du_b * uf
    if delta_softplus:
        pre = delta.float()
        if delta_bias is not None:
            pre = pre + delta_bias.float()[:, None]
        ddt = ddt * torch.sigmoid(pre)
    dD = None
    if D is not None:
        dD = torch.einsum("bdl,bdl->d", gyf, uf)
        du = du + D.float()[None, :, None] * gyf
    dbias = ddt.sum((0, 2)) if delta_bias is not None else None

    cast = lambda gr, t: None if t is None else gr.reshape(t.shape).to(
        t.dtype)
    return (cast(du, u), cast(ddt, delta), cast(dA, A), cast(dB, B),
            cast(dC, C), cast(dD, D), cast(dbias, delta_bias))


class SelectiveScan(torch.autograd.Function):
    """Autograd op of :func:`selective_scan`: saves its inputs, and
    recomputes in the backward (:func:`selective_scan_bwd`)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, delta_softplus,
                return_last_state, out_dtype):
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias)
        ctx.delta_softplus = delta_softplus
        B4, C4 = _bc4(B), _bc4(C)
        if A.shape[-1] == 1 and delta_softplus and not return_last_state:
            return selective_scan_n1(u, delta, A, B4, C4, D, delta_bias,
                                     out_dtype)
        y, h = _rows_forward(u, delta, A, B4, C4, D, delta_bias,
                             delta_softplus, out_dtype)
        if return_last_state:
            return y, h[..., -1].contiguous()
        return y

    @staticmethod
    def backward(ctx, gy, *gh_last):
        grads = selective_scan_bwd(*ctx.saved_tensors, gy,
                                   ctx.delta_softplus, *gh_last)
        return (*grads, None, None, None)


def selective_scan(u, delta, A, B, C, D: Optional[torch.Tensor] = None,
                   delta_bias: Optional[torch.Tensor] = None,
                   delta_softplus: bool = False,
                   return_last_state: bool = False, out_dtype=None):
    """Selective scan with the reference CUDA extension's semantics.
    ``out_dtype=torch.float32`` with low-precision inputs is the "oflex"
    variant; None keeps u's dtype. With ``return_last_state`` returns
    (y, h_L) where h_L is (batch, dim, N) fp32. Differentiable in every
    tensor argument (:class:`SelectiveScan`)."""
    B4, C4 = _bc4(B), _bc4(C)
    batch, dim, L = u.shape
    G, N = B4.shape[1], A.shape[-1]
    if delta.shape != u.shape or A.shape != (dim, N) \
            or B4.shape != (batch, G, N, L) or C4.shape != B4.shape \
            or dim % G:
        raise ValueError(f"selective_scan: u {tuple(u.shape)} delta "
                         f"{tuple(delta.shape)} A {tuple(A.shape)} B "
                         f"{tuple(B4.shape)} C {tuple(C4.shape)}")
    return SelectiveScan.apply(u, delta, A, B, C, D, delta_bias,
                               delta_softplus, return_last_state,
                               out_dtype or u.dtype)
