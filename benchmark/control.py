"""Readings that a cell's correctness limits are set from, on the card, at
the cell's own sizes, all seeds in one process:

- the program's numbers on ``--seeds`` seeds (the lower readings);
- the control's on ``--control-seeds`` more: the plain reference put in the
  program's place one precision below the cell's (float8 operands, e4m3
  forward and e5m2 backward, for bf16; TF32 for float32 with TF32 off);
  for the served cell also the program's own int8 scan route
  (``quant_scan``);
- the faults a run can have, planted on the control seeds: for the served
  cell half of each batch left out (its logits zero) and one pixel of a
  served map altered; for a training cell the loss taken over half of each
  batch after a forward over all of it. A step that leaves the state
  unchanged reads 1 on ``change_gap`` by its definition and is not run;
- for a bf16 training cell, the probe of its sound runs' spread: the
  reference with the operands and results of its products in bf16.

A training reading holds the start's numbers and the window's, the latter
prefixed ``window_``.

    python3 benchmark/control.py --workload <cell> [--seeds 12]
        [--control-seeds 3] [--first-seed N] [--out FILE]

One JSON line per reading on standard output (and in ``--out``).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


# the window of a served reading: long enough at the cell's own load to
# serve more volumes than the check samples
SERVE_SECONDS = 4.0


def _serve_reading(harness, cell, cfg, mx, seed, device, variant=None):
    """The served cell's numbers on one seed: the program's, or by
    ``variant`` the reference in float8 put in the program's place
    ("fp8"), the program's int8 scan route ("int8_route"), or a planted
    fault ("half": half of each batch's logits left out; "altered": one
    pixel of each served map changed)."""
    import torch

    from benchmark.reference import msvm_unet
    from ceigm_unet_tpu_torch import models
    T = harness.traffic_kind(mx["kind"]).Traffic(cfg, mx, seed, device)
    with contextlib.ExitStack() as stack:
        if variant == "int8_route":
            stack.enter_context(mock.patch.object(
                models, "build_model",
                functools.partial(models.build_model, quant_scan=True)))
        T.setup()
    nearest = T.volume.zoom_slices_nearest
    if variant == "half":
        forward = T.model.forward

        def half(x, *a, **kw):
            n = x.shape[0] // 2
            y = forward(x[:n], *a, **kw)
            return torch.cat([y, torch.zeros_like(y)])
        T.model.forward = half
    elif variant == "altered":
        def altered(x, hw):
            y = nearest(x, hw).clone()
            y[0, 0, 0] = (y[0, 0, 0] + 1) % cfg["num_classes"]
            return y
        T.volume.zoom_slices_nearest = altered
    try:
        T.window(SERVE_SECONDS)
    finally:
        T.volume.zoom_slices_nearest = nearest
    T.release()
    if variant == "fp8":
        low = msvm_unet.Precision("fp8")
        return T.check(judged=lambda raw: T.reference_logits(raw, low))
    return T.check()


def _half_loss(logits, labels, **kw):
    """The fault: the loss over the first half of the batch alone, after a
    forward over all of it."""
    from ceigm_unet_tpu_torch.losses import dice_ce_loss
    n = logits.shape[0] // 2
    return dice_ce_loss(logits[:n], labels[:n], **kw)


def _train_program(harness, cfg, mx, seed, device, fault=None):
    """The program's set-up and a window as far as its checked steps; with
    ``fault`` "half" the step's loss is ``_half_loss``."""
    from ceigm_unet_tpu_torch.train import trainstep
    T = harness.traffic_kind(mx["kind"]).Traffic(cfg, mx, seed, device)
    with contextlib.ExitStack() as stack:
        if fault == "half":
            stack.enter_context(mock.patch.object(trainstep, "dice_ce_loss",
                                                  _half_loss))
        T.setup()
        T.window(0.0)
    T.release()
    return T


def _both(compare, got, ref):
    """A reading of the start and of the window, the window's numbers
    prefixed ``window_``."""
    out = {}
    for which, prefix in (("start", ""), ("window", "window_")):
        out.update({prefix + k: v for k, v in
                    compare(got[which], ref[which]).items()})
    return out


def _train_readings(harness, cell, cfg, mx, seed, device, control):
    """The training cell's numbers on one seed: the program's; on a
    control seed also the control's (the reference one precision below
    the cell's, resumed from the same state), the half-batch fault's
    (``_half_loss`` planted in the program) and, for a bf16 cell, the
    reference with its products' operands and results in bf16."""
    from benchmark.reference import msvm_unet
    from benchmark.traffic import train_steps
    T = _train_program(harness, cfg, mx, seed, device)
    ref = {w: T.reference(w) for w in ("start", "window")}
    out = [("program", _both(train_steps.compare, T.readings, ref))]
    if control:
        bf16 = mx["dtype"] == "bfloat16"
        low = (dict(P=msvm_unet.Precision("fp8")) if bf16
               else dict(allow_tf32=True))
        out.append(("control", _both(train_steps.compare, {
            w: T.reference(w, **low) for w in ref}, ref)))
        if bf16:
            out.append(("reference_bf16", _both(train_steps.compare, {
                w: T.reference(w, P=msvm_unet.Precision("bf16"))
                for w in ref}, ref)))
        T.stack.close()
        F = _train_program(harness, cfg, mx, seed, device, fault="half")
        out.append(("fault_half", _both(train_steps.compare, F.readings, {
            w: F.reference(w) for w in ref})))
        F.stack.close()
    T.stack.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3000000000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell, cfg, mx = harness.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(seed, what, values):
        line = json.dumps({"cell": args.workload, "seed": seed, "what": what,
                           **values})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    total = args.seeds + args.control_seeds
    for i in range(total):
        seed = args.first_seed + 7919 * i
        is_control = i >= args.seeds
        t = time.perf_counter()
        if mx["kind"] == "volumes":
            read = lambda v=None: _serve_reading(harness, cell, cfg, mx,
                                                 seed, device, v)
            emit(seed, "program", read())
            if is_control:
                emit(seed, "control", read("fp8"))
                emit(seed, "int8_route", read("int8_route"))
                for fault in ("half", "altered"):
                    emit(seed, "fault_" + fault, read(fault))
        else:
            for what, values in _train_readings(harness, cell, cfg, mx, seed,
                                                device, is_control):
                emit(seed, what, values)
        print(f"control: seed {seed} {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
