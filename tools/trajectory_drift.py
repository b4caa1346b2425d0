"""How far fp32 rounding alone parts two runs of ``chip_smoke.py`` phase
27's training trajectory, on the CPU:

    python tools/trajectory_drift.py {gm_tiny,tiny_0230s} LR [LR ...]

For each base LR, phase 27's 20 steps (``chip_smoke._trajectory``: the
training CLI's AdamW and cosine schedule from LR, 2 frozen steps, 64x64,
batch 2, drop-path masks seeded per step) run on the CPU in fp32 on 2
threads, in fp32 on 1 thread and in float64 (every op, through
``chip_smoke.float64_compute``), each in a spawned process; with
``--bf16``, also in bf16 on 2 threads. Printed per pair: the largest share
of phase 27's per-step loss bound (2e-4 * (1 + step) relative) and of its
final-logits bound (rtol 5e-3, atol 5e-3 * max|logit|) that their
difference uses, and the loss's fall over the 20 steps; for bf16 against
fp32, the shares of phase 27's bf16 bounds (5e-2 relative, 0.05 *
max|logit|). With ``--doubled-from K``, also an fp32 run on 2 threads whose
LR is doubled from step K on, against the fp32 run on 2 threads: how far a
fault of that size moves the same shares. Imports nothing of JAX; needs no
card.
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _shares(got, want, bf16=False):
    (lg, gg), (lw, gw) = got, want
    if bf16:
        loss = cs._loss_shares(lg, lw, lambda i, w: cs.TRAJ_BF16_LOSS
                               * abs(w))
        logits = ((gg - gw).abs().max() / gw.abs().max()).item() \
            / cs.TRAJ_BF16_LOGITS
    else:
        loss = cs._loss_shares(lg, lw, lambda i, w: cs.TRAJ_LOSS_RTOL
                               * (1 + i) * max(1.0, abs(w)))
        logits = cs._logit_share(gg, gw, cs.TRAJ_LOGITS_TOL,
                                 cs.TRAJ_LOGITS_TOL)
    at = max(range(len(loss)), key=loss.__getitem__)
    return f"losses {loss[at]:.3f} (step {at}), final logits {logits:.3f}"


def _doubled_trajectory(legacy, lr, start):
    """Phase 27's fp32 trajectory on 2 threads with the LR doubled from step
    ``start`` on, in a process of its own."""
    from ceigm_unet_tpu_torch.train import trainstep
    cosine = trainstep.cosine_lr

    def doubled(*args):
        schedule = cosine(*args)
        return lambda i: schedule(i) * (2.0 if i >= start else 1.0)
    trainstep.cosine_lr = doubled
    return cs._cpu_trajectory(legacy, torch.float32, lr, 2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", choices=("gm_tiny", "tiny_0230s"))
    ap.add_argument("lrs", type=float, nargs="+")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--doubled-from", type=int, default=None)
    args = ap.parse_args(argv)
    legacy = args.model == "tiny_0230s"
    runs = [("fp32 on 2 threads", torch.float32, 2),
            ("fp32 on 1 thread", torch.float32, 1),
            ("float64", torch.float64, 2)]
    if args.bf16:
        runs.append(("bf16 on 2 threads", torch.bfloat16, 2))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(max(1, (os.cpu_count() or 2) // 2)) as pool:
        pending = {(lr, tag): pool.apply_async(
            cs._cpu_trajectory, (legacy, dtype, lr, threads))
            for lr in args.lrs for tag, dtype, threads in runs}
        if args.doubled_from is not None:
            pending.update({(lr, "doubled"): pool.apply_async(
                _doubled_trajectory, (legacy, lr, args.doubled_from))
                for lr in args.lrs})
        out = {k: r.get(timeout=3600)[:2] for k, r in pending.items()}
    for lr in args.lrs:
        r = {tag: out[lr, tag] for tag, *_ in runs}
        exact = r["float64"]
        print(f"{args.model} from LR {lr}: loss falls by "
              f"{exact[0][0] - exact[0][-1]:.4f} over "
              f"{len(exact[0])} steps (float64)")
        for a, b in (("fp32 on 2 threads", "float64"),
                     ("fp32 on 1 thread", "float64"),
                     ("fp32 on 1 thread", "fp32 on 2 threads")):
            print(f"  {a} vs {b}: {_shares(r[a], r[b])}")
        base = r["fp32 on 2 threads"]
        if args.doubled_from is not None:
            print(f"  LR doubled from step {args.doubled_from} vs fp32 on 2 "
                  f"threads: {_shares(out[lr, 'doubled'], base)}")
        if args.bf16:
            print(f"  bf16 vs fp32 on 2 threads: "
                  f"{_shares(r['bf16 on 2 threads'], base, True)}")


if __name__ == "__main__":
    main()
