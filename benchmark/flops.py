"""The yardstick's arithmetic: the chip's peaks, the architecture's matrix
FLOPs, and the bytes two hand-written kernels must move, all from a
configuration's shapes and never from an implementation.

FLOPs count the architecture's matrix products and convolutions (the
depthwise and grouped ones too), 2 per multiply-add, at every position
they are applied to; the selective scans, norms, activations, pooling,
resampling and every other elementwise step are left out.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense: FLOP/s by compute dtype, HBM bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

FRONT_DEPTHS = (3, 2, 2)
GROUPS = 4                       # scan groups of a quad block
OFFSET_CHANNELS = 2 * 4 * 2 * 2  # DySample: 2 coordinates x 4 groups x 2x2


def reduced_channels(c: int, ratio: int = 16) -> int:
    """MultiScaleCAB's reduced width."""
    factor = max(1, c // ratio // 3)
    while c % factor != 0:
        factor += 1
    return factor


def _quad_block_macs(c: int, hw: int) -> int:
    """The GroupMamba layer of one block: SE fc1 / fc2 on the pooled
    vector, four scan groups (in projection, depthwise 3x3, x and dt
    projections, out projection), the output projection."""
    d = c // GROUPS
    r = math.ceil(d / 16)
    group = hw * (d * 2 * d + 9 * d + d * (r + 2) + r * d + d * d)
    return 2 * c * (c // 16) + GROUPS * group + hw * c * c


def _ffn_macs(c: int, hw: int, ratio: float, custom: bool) -> int:
    hid = int(c * ratio)
    macs = hw * (2 * c * hid + 9 * hid)
    if custom:
        g = int(hid * 0.125)
        macs += hw * g * (9 + 25 + 49)
    return macs


def _mscam_macs(c: int, hw: int) -> int:
    rc = reduced_channels(c)
    return (2 * hw * (c // 2) * c                 # shared 1x1 on both halves
            + 2 * c * rc + c + rc + 3 * rc * c    # channel attention, pooled
            + hw * 2 * (9 + 49 + 121)             # spatial attention
            + hw * 2 * c * c)                     # fusion 1x1


def stages(cfg: Dict, img: int) -> List[Tuple[int, int]]:
    """(side, channels) of the four encoder stages."""
    return [(img // (4 << i), c) for i, c in enumerate(cfg["embed_dims"])]


def quad_blocks(cfg: Dict, img: int) -> List[Tuple[int, int]]:
    """(side, channels) of every quad block of one forward, in order: the
    encoder's, then the decoder's Front blocks."""
    st = stages(cfg, img)
    blocks = [s for s, n in zip(st, cfg["depths"]) for _ in range(n)]
    for i, n in enumerate(FRONT_DEPTHS):
        blocks += [st[2 - i]] * n
    return blocks


def forward_flops(cfg: Dict, img: int) -> int:
    """Matrix FLOPs of one (img x img, 1 channel) slice's forward."""
    st = stages(cfg, img)
    s0 = cfg["stem_hidden_dim"]
    h1 = (img // 2) ** 2
    macs = h1 * s0 * 3 * 49 + 2 * h1 * s0 * s0 * 9      # stem convs
    prev = s0
    for i, ((side, c), depth) in enumerate(zip(st, cfg["depths"])):
        hw = side * side
        macs += hw * c * prev * 9                        # strided 3x3
        macs += depth * (_quad_block_macs(c, hw) + _ffn_macs(
            c, hw, cfg["mlp_ratios"][i], False))
        prev = c
    macs += _mscam_macs(st[3][1], st[3][0] ** 2)
    for i in range(3):
        (side, cin), (side2, cout) = st[3 - i], st[2 - i]
        hw, hw2 = side * side, side2 * side2
        macs += hw * (cin * OFFSET_CHANNELS + OFFSET_CHANNELS ** 2 * 9)
        macs += hw2 * (9 * cin + cin * cout)             # EUCB
        f = cout // 2
        macs += hw2 * f * (2 * 2 * (1 + 9 + 25) + 1)     # LGAG
        macs += FRONT_DEPTHS[i] * (_quad_block_macs(cout, hw2)
                                   + _ffn_macs(cout, hw2, 4.0, True))
        macs += _mscam_macs(cout, hw2)
    macs += st[0][0] ** 2 * st[0][1] * cfg["num_classes"]  # head
    return 2 * macs


def k1_bytes(batch: int, side: int, c: int, itemsize: int) -> int:
    """K1 (quad scan + group LayerNorm), one launch: u and dt read and the
    output written in the compute dtype, B and C read, 5 (K, D) fp32
    constants."""
    el = batch * side * side * c
    return itemsize * (3 * el + 2 * batch * GROUPS * side * side) + 20 * c


def k8_bytes(batch: int, side: int, c: int) -> int:
    """K8 (scan2d, either mode), one launch: a and b read, h written, fp32."""
    return 12 * batch * side * side * c


def bound_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
