"""Plain PyTorch reference of MSVM-UNet: the GroupMamba encoder and the
EMCAD decoder, forward in eval and training mode, in float32.

A functional copy of the architecture over a state dict whose keys are the
served model's (``encoder.gm_encoder.*``, ``decoder.*``). Every tensor the
served program derives from the weights (the block-diagonal quad
projections, the CustomFfn composite kernel, the LGAG fold) is worked out
again here from the raw weights, module by module:

- each of the four scan groups of a quad block is its own SS2D (in
  projection, depthwise 3x3, x / dt projections, a d_state 1 selective scan
  in the group's direction by a plain doubling scan, LayerNorm, z gate, out
  projection);
- the inception mixer is its three depthwise convolutions on their channel
  slices, added back to the input;
- LGAG is its six grouped convolutions and two BatchNorms, unfolded.

It imports neither JAX nor the served package. ``Precision`` rounds the
operands and results of every matrix product and convolution; the default
leaves them in float32, the control rounds them to float8, and ``"bf16"``
to bfloat16, as the bf16 program stores them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FRONT_DEPTHS = (3, 2, 2)
DIRECTIONS = (1, 2, 3, 4)     # row-major, column-major, and both reversed
BN_EPS = 1e-5

Params = Dict[str, torch.Tensor]
Mask = Optional[Tuple[torch.Tensor, float]]


def _fp8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """t rounded to a float8 format with a per-tensor scale (amax / top)."""
    s = t.abs().amax().clamp_min(1e-30) / top
    return (t / s).to(dtype).to(t.dtype) * s


class _Fp8Operand(torch.autograd.Function):
    """An operand in float8 as fp8 training holds it: e4m3 in the forward,
    its gradient e5m2 in the backward."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class _Bf16Operand(torch.autograd.Function):
    """An operand rounded to bfloat16, and its gradient too."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class Precision:
    """How the tensors into and out of matrix products and convolutions
    are stored. ``"fp32"`` leaves them; ``"fp8"`` rounds each operand and
    each result to float8 with a per-tensor scale, e4m3 in the forward and
    its gradient e5m2 in the backward: the reference computed one
    precision below bf16, as the bf16 program stores those tensors in
    bf16 (the control); ``"bf16"`` rounds them, and their gradients, to
    bfloat16 (what bf16 storage alone does to the reference)."""

    ROUND = {"fp8": _Fp8Operand, "bf16": _Bf16Operand}

    def __init__(self, operands: str = "fp32"):
        if operands not in ("fp32", *self.ROUND):
            raise ValueError(f"Precision: operands {operands!r}")
        self.operands = operands

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.operands == "fp32" else \
            self.ROUND[self.operands].apply(t)


FP32 = Precision()


def _lin(P: Precision, x, w, b=None):
    return P(F.linear(P(x), P(w), b))


def _conv(P: Precision, x, w, b=None, stride=1, padding=0, dilation=1,
          groups=1):
    """Convolution of NHWC x with a torch (out, in/groups, kh, kw) kernel."""
    y = F.conv2d(P(x).permute(0, 3, 1, 2), P(w), b, stride, padding,
                 dilation, groups)
    return P(y.permute(0, 2, 3, 1))


def _ln(p: Params, pre: str, x, eps: float):
    return F.layer_norm(x, (x.shape[-1],), p[pre + ".weight"],
                        p[pre + ".bias"], eps)


def _bn(p: Params, pre: str, x, train: bool):
    """BatchNorm over (B, H, W): batch mean and biased variance in
    training, the running statistics in eval."""
    if train:
        var, mean = torch.var_mean(x, dim=(0, 1, 2), unbiased=False)
    else:
        mean, var = p[pre + ".running_mean"], p[pre + ".running_var"]
    return (x - mean) * torch.rsqrt(var + BN_EPS) * p[pre + ".weight"] \
        + p[pre + ".bias"]


def _drop(x, mask: Mask):
    """Stochastic depth: samples kept by ``mask`` scaled by 1 / keep."""
    if mask is None:
        return x
    m, keep = mask
    return torch.where(m, x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------- scan

def _walk(t, d: int):
    """(B, H, W, D) -> (B, H*W, D) in the order direction d visits."""
    if d in (2, 4):
        t = t.transpose(1, 2)
    t = t.reshape(t.shape[0], -1, t.shape[-1])
    return t.flip(1) if d in (3, 4) else t


def _unwalk(t, d: int, H: int, W: int):
    if d in (3, 4):
        t = t.flip(1)
    B, _, D = t.shape
    if d in (2, 4):
        return t.reshape(B, W, H, D).transpose(1, 2)
    return t.reshape(B, H, W, D)


def linear_recurrence(a, b):
    """h_t = a_t * h_{t-1} + b_t along dim 1, h_{-1} = 0, by doubling."""
    L, s = a.shape[1], 1
    while s < L:
        b = torch.cat([b[:, :s], b[:, s:] + a[:, s:] * b[:, :-s]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def _ss2d_group(P: Precision, p: Params, pre: str, x, d: int):
    """One scan group (d_state 1, ssm_ratio 1, d_conv 3) over (B, H, W, D)
    in direction d."""
    B, H, W, D = x.shape
    xz = _lin(P, x, p[pre + ".in_proj.weight"])
    xc, z = xz[..., :D], xz[..., D:]
    xc = F.silu(_conv(P, xc, p[pre + ".conv2d.weight"],
                      p[pre + ".conv2d.bias"], padding=1, groups=D))
    R = p[pre + ".dt_projs_weight"].shape[-1]
    x_dbl = _lin(P, xc, p[pre + ".x_proj_weight"][0])        # (.., R + 2)
    dt = _lin(P, x_dbl[..., :R], p[pre + ".dt_projs_weight"][0])
    Bc, Cc = x_dbl[..., R:R + 1], x_dbl[..., R + 1:R + 2]
    A = -torch.exp(p[pre + ".A_logs"][:, 0])
    delta = F.softplus(dt + p[pre + ".dt_projs_bias"][0])
    h = _unwalk(linear_recurrence(_walk(torch.exp(delta * A), d),
                                  _walk(delta * xc * Bc, d)), d, H, W)
    y = Cc * h + p[pre + ".Ds"] * xc
    y = F.layer_norm(y, (D,), p[pre + ".out_norm.weight"],
                     p[pre + ".out_norm.bias"], 1e-5)
    return _lin(P, y * F.silu(z), p[pre + ".out_proj.weight"])


def _gm_layer(P: Precision, p: Params, pre: str, x):
    """LN -> channel affinity -> four scan groups * skip_scale * x ->
    modulation -> the same LN again -> projection."""
    Dg = x.shape[-1] // len(DIRECTIONS)
    xn = _ln(p, pre + ".norm", x, 1e-5)
    hid = F.relu(_lin(P, xn.mean(dim=(1, 2)), p[pre + ".fc1.weight"],
                      p[pre + ".fc1.bias"]))
    aff = torch.sigmoid(_lin(P, hid, p[pre + ".fc2.weight"],
                             p[pre + ".fc2.bias"]))[:, None, None, :]
    y = torch.cat([_ss2d_group(P, p, f"{pre}.mamba_g{k + 1}",
                               xn[..., k * Dg:(k + 1) * Dg], d)
                   for k, d in enumerate(DIRECTIONS)], dim=-1)
    y = y * p[pre + ".skip_scale"] * xn
    return _lin(P, _ln(p, pre + ".norm", y * aff, 1e-5),
                p[pre + ".proj.weight"], p[pre + ".proj.bias"])


# ---------------------------------------------------------------- FFNs

def _dw(P, p, pre, x, k, bias=True):
    return _conv(P, x, p[pre + ".weight"], p[pre + ".bias"] if bias else None,
                 padding=k // 2, groups=x.shape[-1])


def _pvt2_ffn(P: Precision, p: Params, pre: str, x):
    h = _lin(P, x, p[pre + ".fc1.weight"], p[pre + ".fc1.bias"])
    h = F.gelu(_dw(P, p, pre + ".dwconv.dwconv", h, 3))
    return _lin(P, h, p[pre + ".fc2.weight"], p[pre + ".fc2.bias"])


def _custom_ffn(P: Precision, p: Params, pre: str, x):
    """fc1 -> depthwise 3x3 -> GELU -> inception mixer (identity | 3x3 |
    5x5 | 7x7 on the channel slices, added to its input) -> fc2."""
    h = _lin(P, x, p[pre + ".fc1.weight"], p[pre + ".fc1.bias"])
    q = F.gelu(_dw(P, p, pre + ".dwconv.dwconv", h, 3))
    hid = q.shape[-1]
    g = int(hid * 0.125)
    n = hid - 3 * g
    mix = torch.cat([q[..., :n]] + [
        _dw(P, p, f"{pre}.custom.dwconv_{k}x{k}",
            q[..., n + i * g:n + (i + 1) * g], k)
        for i, k in enumerate((3, 5, 7))], dim=-1)
    return _lin(P, q + mix, p[pre + ".fc2.weight"], p[pre + ".fc2.bias"])


def _block(P: Precision, p: Params, pre: str, x, norm_eps: float,
           custom: bool, masks: Tuple[Mask, Mask]):
    x = x + _drop(_gm_layer(P, p, pre + ".attn", x), masks[0])
    ffn = _custom_ffn if custom else _pvt2_ffn
    return x + _drop(ffn(P, p, pre + ".mlp",
                         _ln(p, pre + ".norm2", x, norm_eps)), masks[1])


def _run_block(ckpt: bool, *args):
    """A block, recomputed in the backward when ``ckpt`` (the masks are
    drawn beforehand, so a recomputation reads the same ones)."""
    if ckpt and torch.is_grad_enabled():
        P, p, pre, x, eps, custom, masks = args
        return checkpoint(lambda t: _block(P, p, pre, t, eps, custom, masks),
                          x, use_reentrant=False)
    return _block(*args)


# ---------------------------------------------------------------- encoder

def encoder(P: Precision, p: Params, x, depths: Sequence[int], train: bool,
            ckpt: bool = False) -> List[torch.Tensor]:
    """(B, H, W, 3) -> the four stage outputs at strides 4, 8, 16, 32."""
    pre = "encoder.gm_encoder"
    feats = []
    for i, depth in enumerate(depths):
        emb = f"{pre}.patch_embed{i + 1}"
        if i == 0:
            for j, (k, s) in enumerate(((7, 2), (3, 1), (3, 1))):
                x = _conv(P, x, p[f"{emb}.conv.{3 * j}.weight"], None, s,
                          k // 2)
                x = F.relu(_bn(p, f"{emb}.conv.{3 * j + 1}", x, train))
        x = _conv(P, x, p[emb + ".proj.weight"], p[emb + ".proj.bias"], 2, 1)
        x = _ln(p, emb + ".norm", x, 1e-5)
        for j in range(depth):
            x = _run_block(ckpt, P, p, f"{pre}.block{i + 1}.{j}", x, 1e-6,
                           False, (None, None))
        x = _ln(p, f"{pre}.norm{i + 1}", x, 1e-6)
        feats.append(x)
    return feats


# ---------------------------------------------------------------- decoder

def _cab(P: Precision, p: Params, pre: str, x):
    """Channel attention from the average, max and min pools."""
    w21 = p[pre + ".conv2_1.weight"]
    rc = w21.shape[0]
    comb = torch.cat([
        _conv(P, x.mean((1, 2), keepdim=True), p[pre + ".conv1.weight"]),
        _conv(P, _conv(P, x.amax((1, 2), keepdim=True), w21, groups=rc),
              p[pre + ".conv2_2.weight"], groups=rc),
        _conv(P, x.amin((1, 2), keepdim=True), p[pre + ".conv3.weight"])],
        dim=-1)
    return torch.sigmoid(_conv(P, comb, p[pre + ".fc.0.weight"]) + x)


def _sab(P: Precision, p: Params, pre: str, x):
    """Spatial attention: channel mean and max -> 3x3 + 7x7 + 11x11."""
    cat = torch.cat([x.mean(-1, keepdim=True), x.amax(-1, keepdim=True)], -1)
    return torch.sigmoid(sum(_conv(P, cat, p[f"{pre}.conv{k}.weight"],
                                   padding=k // 2) for k in (3, 7, 11)))


def _mscam(P: Precision, p: Params, idx: int, d):
    """Even / odd channels through one shared 1x1, then the parallel
    attention fusion."""
    w, b = p[f"decoder.cc{idx}.cw.weight"], p[f"decoder.cc{idx}.cw.bias"]
    x1, x2 = _conv(P, d[..., 0::2], w, b), _conv(P, d[..., 1::2], w, b)
    pre = f"decoder.para{idx}"
    ca_w = 0.5 + torch.atan(math.pi * p[pre + ".x"]) / math.pi
    fusion = torch.cat([x1 * _cab(P, p, pre + ".channel_attention", x1) * ca_w,
                        x2 * _sab(P, p, pre + ".spatial_attention", x2)
                        * (1.0 - ca_w)], dim=-1)
    return (x1 + x2) * torch.sigmoid(_conv(
        P, fusion, p[pre + ".final_conv.weight"], p[pre + ".final_conv.bias"]))


def _dysample(P: Precision, p: Params, pre: str, x, train: bool):
    """Dynamic 2x upsampling (4 groups, base grid i + sin(pi (i+1) / S),
    bilinear, border clamp), then depthwise 3x3 + BN + ReLU + 1x1."""
    s, g = 2, 4
    B, H, W, C = x.shape
    off = _conv(P, _conv(P, x, p[pre + ".offset.0.weight"],
                         p[pre + ".offset.0.bias"]),
                p[pre + ".offset.1.weight"], padding=2, dilation=2)
    base = torch.tensor([-0.25, 0.25], device=x.device)
    pos = torch.stack([base[None, None, :].expand(g, s, s),
                       base[None, :, None].expand(g, s, s)])   # (2, g, s, s)
    off = (off / g + pos.reshape(-1)).reshape(B, H, W, 2, g, s, s)
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=x.device)
    bw = ar(W) + torch.sin(math.pi * (ar(W) + 1) / W)
    bh = ar(H) + torch.sin(math.pi * (ar(H) + 1) / H)
    cx = 2.0 * (bw[None, None, :, None, None, None] + off[..., 0, :, :, :]) \
        / W - 1.0
    cy = 2.0 * (bh[None, :, None, None, None, None] + off[..., 1, :, :, :]) \
        / H - 1.0
    # subpixel (j, i) of pixel (h, w) is output pixel (h*s + j, w*s + i)
    shuffle = lambda c: c.permute(0, 1, 4, 2, 5, 3).reshape(
        B, H * s, W * s, g)
    grid = torch.stack([shuffle(cx), shuffle(cy)], dim=-1)
    xg = x.reshape(B, H, W, g, C // g).permute(0, 3, 4, 1, 2).reshape(
        B * g, C // g, H, W)
    gg = grid.permute(0, 3, 1, 2, 4).reshape(B * g, H * s, W * s, 2)
    y = F.grid_sample(xg, gg, mode="bilinear", padding_mode="border",
                      align_corners=False)
    y = y.reshape(B, g, C // g, H * s, W * s).permute(0, 3, 4, 1, 2).reshape(
        B, H * s, W * s, C)
    eu = pre + ".eu"
    y = F.relu(_bn(p, eu + ".up_dwc.1", _conv(
        P, y, p[eu + ".up_dwc.0.weight"], padding=1, groups=C), train))
    return _conv(P, y, p[eu + ".pwc.0.weight"], p[eu + ".pwc.0.bias"])


def _lgag(P: Precision, p: Params, pre: str, g, x, train: bool):
    """Grouped attention gate: both branches read g (a reference quirk),
    one BatchNorm applied to each branch sum, ReLU, 1x1 + BN, sigmoid."""
    C2 = g.shape[-1] // 2
    branch = lambda a: sum(_conv(P, g, p[f"{pre}.W_{a}_{k}.weight"],
                                 p[f"{pre}.W_{a}_{k}.bias"], padding=k // 2,
                                 groups=C2) for k in (1, 3, 5))
    r = F.relu(_bn(p, pre + ".bn", branch("g"), train)
               + _bn(p, pre + ".bn", branch("x"), train))
    psi = _bn(p, pre + ".psi.1", _conv(P, r, p[pre + ".psi.0.weight"],
                                       p[pre + ".psi.0.bias"]), train)
    return x * torch.sigmoid(psi)


def drop_rates(rate: float) -> List[float]:
    """The Front blocks' stochastic depth rates, rate down to 0."""
    return [float(r) for r in np.linspace(rate, 0.0, sum(FRONT_DEPTHS))]


def draw_masks(batch: int, rate: float, generator: torch.Generator
               ) -> List[Tuple[Mask, Mask]]:
    """The keep masks of each Front block's two residual branches, drawn
    in the order the blocks run: one uniform draw of (batch, 1, 1, 1) per
    branch with a rate above 0, kept below 1 - rate."""
    masks = []
    for r in drop_rates(rate):
        pair = []
        for _ in range(2):
            if r > 0.0:
                keep = 1.0 - r
                u = torch.rand((batch, 1, 1, 1), generator=generator,
                               device=generator.device)
                pair.append((u < keep, keep))
            else:
                pair.append(None)
        masks.append(tuple(pair))
    return masks


def decoder(P: Precision, p: Params, feats: List[torch.Tensor], train: bool,
            masks: Optional[List[Tuple[Mask, Mask]]] = None,
            ckpt: bool = False):
    """The four stage outputs, fine to coarse -> logits at 4x the finest."""
    masks = masks or [(None, None)] * sum(FRONT_DEPTHS)
    d = _mscam(P, p, 4, feats[3])
    blk = 0
    for i, idx in enumerate((3, 2, 1)):
        d = _dysample(P, p, f"decoder.eucb{idx}", d, train)
        d = d + _lgag(P, p, f"decoder.lgag{idx}", d, feats[2 - i], train)
        for j in range(FRONT_DEPTHS[i]):
            d = _run_block(ckpt, P, p, f"decoder.f{i + 1}.cm_layer.blocks.{j}",
                           d, 1e-5, True, masks[blk])
            blk += 1
        d = _mscam(P, p, idx, d)
    out = _conv(P, d, p["decoder.out_head1.weight"], p["decoder.out_head1.bias"])
    out = F.interpolate(out.permute(0, 3, 1, 2), scale_factor=4,
                        mode="bilinear", align_corners=False)
    return out.permute(0, 2, 3, 1)


def forward(p: Params, x: torch.Tensor, depths: Sequence[int],
            train: bool = False, masks=None, P: Precision = FP32,
            ckpt: bool = False) -> torch.Tensor:
    """(B, H, W, 1|3) float32 NHWC -> (B, H, W, classes) float32 logits."""
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    feats = encoder(P, p, x.float(), depths, train, ckpt)
    return decoder(P, p, feats, train, masks, ckpt)
