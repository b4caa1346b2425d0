"""Time variants of the port's CustomFfn stencil (``cffn_dw3_inception7``,
or an older library's ``cffn_dw3_gelu`` followed by its ``cffn_inception7``),
of K5 (``lgag_gate``) and of K12 (``selective_scan_n1``), each built from a
copy of ``ceigm_unet_tpu_torch/csrc/``, on one NVIDIA card:

    python tools/port_stencil_variants.py [--lgag] [--n1-only] DIR [DIR ...]

DIR is a ``csrc/`` copy; its parent directory's name labels it (with the
grandparent's in front where two parents share a name). At the
three b128 CustomFfn shapes (fp32 hidden, the composite's taps) each
variant is checked against ``dw3_gelu_inception7_ref`` (max abs error
printed) and timed as device time (``kernel_ab.device_time``, median of
3) with the model's identity channels, with none (``n_id`` 0: every
channel tapped) and with all (``n_id`` = HID); with ``--lgag``, also K5 at
its three b128 bf16 shapes; with ``--n1-only``, only K12 at the selective
scan's speed-test shape (B 128, D 96, N 1, L 4096, bf16 in) with fp32 and
bf16 out, against ``selective_scan_n1_ref``. A variant whose build fails
is reported and left out. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import statistics
import tempfile
from pathlib import Path

import torch

from ceigm_unet_tpu_torch.kernel_ab import (HBM_BPS, LGAG, N1_SHAPE,
                                            STENCIL, _lgag, _n1,
                                            _n1_takes_dtypes, _stencil,
                                            device_time)
from ceigm_unet_tpu_torch.ops import _build, ffn, selective_scan, tapconv


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path, help="csrc/ copies")
    ap.add_argument("--lgag", action="store_true", help="also time K5")
    ap.add_argument("--n1-only", action="store_true",
                    help="time only K12")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("port_stencil_variants: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    libs, new = {}, {}
    for d in args.dirs:
        d = d.resolve()
        name = d.parent.name
        if name in libs:
            name = f"{d.parent.parent.name}/{name}"
        try:
            libs[name] = _build.load(
                _build.build(d, Path(tempfile.mkdtemp())), strict=False)
            new[name] = _n1_takes_dtypes(libs[name], d)
        except RuntimeError as e:
            print(f"build failed: {d}: {str(e)[-3000:]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda shape, scale=1.0: torch.randn(
        shape, generator=gen, device="cuda") * scale
    med = lambda fn: statistics.median(device_time(fn) for _ in range(3))
    if args.n1_only:
        n1_variants(libs, new, rnd, med)
        return 0
    totals = {}
    for S, HID, n_id, calls in STENCIL:
        g = HID // 8
        k, bias = ffn.inception_composite(
            HID, g, rnd((3, 3, 1, g), .2), rnd((5, 5, 1, g), .1),
            rnd((7, 7, 1, g), .05), rnd((g,), .1), rnd((g,), .1),
            rnd((g,), .1), torch.float32)
        taps = k.reshape(49, HID).contiguous()
        dwk, dwb = rnd((3, 3, 1, HID), .2), rnd((HID,), .1)
        dw9 = dwk.reshape(9, HID).contiguous()
        h = rnd((128 * S * S, HID))
        plain = ffn.dw3_gelu_inception7_ref(h, dwk, dwb, k, bias, S, S, n_id)
        bound = 8 * h.numel() / HBM_BPS * 1e3
        for name, lib in libs.items():
            run = lambda nid: _stencil(lib, h, dw9, dwb, taps, bias, S, nid)
            err = (run(n_id) - plain).abs().max().item()
            ms = [med(lambda: run(nid)) for nid in (n_id, 0, HID)]
            totals[name] = totals.get(name, 0.0) + calls * ms[0]
            print(f"stencil {S}x{S} HID{HID} {name}: {ms[0]:.4f} ms (every "
                  f"channel tapped {ms[1]:.4f}, none {ms[2]:.4f}), bound "
                  f"{bound:.4f}, max abs err {err:.2e} (max|plain| "
                  f"{plain.abs().max().item():.2e})", flush=True)
        del h, plain
    print("stencil per b128 forward, device ms: "
          + ", ".join(f"{n} {v:.4f}" for n, v in totals.items()), flush=True)
    if not args.lgag:
        return 0
    totals = {}
    for S, C, calls in LGAG:
        C2 = C // 2
        g, x = [rnd((128, S, S, C)).to(torch.bfloat16) for _ in range(2)]
        prm = [rnd((5, 5, 2, C2), .2), 1 + rnd((C2,), .1), rnd((C2,), .1),
               rnd((C2,), .3), rnd((3,), .5)]
        plain = tapconv.lgag_gate_ref(g, x, *prm).float()
        for name, lib in libs.items():
            err = (_lgag(lib, g, x, prm).float() - plain).abs().max().item()
            ms = med(lambda: _lgag(lib, g, x, prm))
            totals[name] = totals.get(name, 0.0) + calls * ms
            print(f"lgag {S}x{S} C{C} {name}: {ms:.4f} ms, bound "
                  f"{6 * g.numel() / HBM_BPS * 1e3:.4f}, max abs err "
                  f"{err:.2e}", flush=True)
    print("lgag per b128 bf16 forward, device ms: "
          + ", ".join(f"{n} {v:.4f}" for n, v in totals.items()), flush=True)
    return 0


def n1_variants(libs, new, rnd, med):
    """K12 at the speed-test shape, fp32 and bf16 out, on each variant (an
    older entry point on the fp32 B and C copies its wrapper made)."""
    batch, dim, L = N1_SHAPE
    bf16 = torch.bfloat16
    u, delta = rnd((batch, dim, L)).to(bf16), rnd((batch, dim, L), .1).to(bf16)
    A = -torch.exp(rnd((dim, 1), .5))
    B, C = [rnd((batch, 1, 1, L)).to(bf16) for _ in "BC"]
    D, bias = rnd((dim,)), rnd((dim,), .3)
    f32 = (B[:, :, 0].float().contiguous(), C[:, :, 0].float().contiguous(),
           A[:, 0].contiguous())
    for od in (torch.float32, bf16):
        args = (u, delta, A, B, C, D, bias, od)
        plain = selective_scan.selective_scan_n1_ref(*args).float()
        bound = ((4 + od.itemsize) * u.numel() + 4 * B.numel() + 12 * dim
                 ) / HBM_BPS * 1e3
        for name, lib in libs.items():
            run = lambda: _n1(lib, new[name], *args, f32)
            err = (run().float() - plain).abs().max().item()
            ms = med(run)
            print(f"selective_scan_n1 out {str(od).split('.')[-1]} {name}: "
                  f"{ms:.4f} ms, bound {bound:.4f}, max abs err {err:.2e} "
                  f"(max|plain| {plain.abs().max().item():.2e})", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
