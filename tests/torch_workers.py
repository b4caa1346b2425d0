"""Tasks that tests/test_torch_parallel.py runs in spawned ranks.

The ranks import torch and the port only (``tests/conftest.py``, which
imports JAX, is never loaded there); ``parallel.dryrun.spawn`` joins them in
one gloo group and pickles these functions by name.
"""
import contextlib

import torch

from ceigm_unet_tpu_torch.parallel import dryrun, mesh
from ceigm_unet_tpu_torch.train import trainstep


@contextlib.contextmanager
def injected_draws(draws):
    """The train step's augmentation parameters taken from ``draws`` (one
    dict of numpy arrays per step, for the global batch) instead of its
    generator: the draws of another implementation."""
    it = iter(draws)
    saved = trainstep.sample_params
    trainstep.sample_params = lambda gen, total, h, w, out, device: {
        k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
    try:
        yield
    finally:
        trainstep.sample_params = saved


def trajectories(cases, draws):
    """For each case (image, label, frozen flags, device augmentation):
    the trajectory with stochastic depth on (drop-path 0.2), and the one
    with it off, with ``draws`` injected where the case augments on the
    device (the JAX side's draws)."""
    out = {}
    for name, (image, label, frozen, aug) in cases.items():
        size = 32 if aug else None
        out[name] = dryrun.trajectory(image, label, frozen,
                                      device_aug_size=size)
        with injected_draws(draws) if aug else contextlib.nullcontext():
            out[name, "no drop-path"] = dryrun.trajectory(
                image, label, frozen, drop_path_rate=0.0,
                device_aug_size=size)
    return out


def losses(logits, labels, weights):
    """Each loss of ``losses.py`` on this rank's rows of the global
    (logits, labels), with the gradient of the logits rows (``weights``:
    the class weights of the weighted cross-entropy and Dice)."""
    from ceigm_unet_tpu_torch import losses as L
    rows = mesh.shard_batch({"x": torch.from_numpy(logits),
                             "y": torch.from_numpy(labels)})
    w = torch.from_numpy(weights)
    fns = {"dice_ce": lambda x, y: L.dice_ce_loss(x, y, 0.4, 0.6),
           "weighted": lambda x, y: L.dice_ce_loss(x, y, 0.4, 0.6, w, w),
           "dice_focal": lambda x, y: L.dice_focal_loss(x, y, alpha=0.25)}
    out = {}
    for name, fn in fns.items():
        x = rows["x"].clone().requires_grad_()
        loss = fn(x, rows["y"])
        loss.backward()
        out[name] = loss.item(), x.grad.numpy()
    return out


def inference(image):
    """This rank's rows of the eval forward of the global batch, and the
    ``torch.distributed`` calls made during it."""
    from ceigm_unet_tpu_torch.models import build_model
    model = build_model(num_classes=4, enc_name="gm_test", device="cpu")
    x = mesh.shard_batch({"x": torch.from_numpy(image)})["x"]
    with mesh.watch_collectives() as calls, torch.no_grad():
        logits = model(x)
    return logits.numpy(), calls


def training_loop(cfg, data_dir, list_dir):
    """``run_training`` on the ACDC-format slices, 2 steps, each rank with
    log and checkpoint directories of its own (``<dir>/rank<r>``), so that
    the test can see which rank wrote."""
    import dataclasses
    import os

    from ceigm_unet_tpu_torch.data.datasets import ACDCDataset
    from ceigm_unet_tpu_torch.train import loop
    rank, _ = mesh.rank_and_size()
    cfg = dataclasses.replace(
        cfg, log_dir=os.path.join(cfg.log_dir, f"rank{rank}"),
        ckpt_dir=os.path.join(cfg.ckpt_dir, f"rank{rank}"))
    ds = ACDCDataset(data_dir, "train", list_dir, cfg.img_size, seed=cfg.seed)
    val = ACDCDataset(data_dir, split="test", list_dir=list_dir,
                      augment=False)
    _, step = loop.run_training(cfg, ds, [val[i] for i in range(len(val))],
                                max_steps=2, device="cpu")
    return step.count


def dp_cases(cases, draws, image, loss_args, loop_args):
    """Every data-parallel case of the test module, in one group."""
    return {"trajectories": trajectories(cases, draws),
            "losses": losses(*loss_args),
            "inference": inference(image),
            "loop": training_loop(*loop_args)}


def ring_cases(scan, grad, sp, sp_grad):
    """This rank's shards of the ring scan's results on the global inputs:
    the forward and the gradients of sum(h * ct) (``scan``: a, b; ``grad``:
    a, b, ct), each forward and reverse, with the ``torch.distributed``
    calls of the gradients' forward and backward; ``selective_scan_sp``'s forward
    (``sp``) and, scanning in reverse, the gradients of sum(y^2) in u,
    delta, B and C (``sp_grad``)."""
    from ceigm_unet_tpu_torch.parallel import (selective_scan_sp,
                                               sequence_parallel_scan)
    rank, n = mesh.rank_and_size()

    def part(x):
        x = torch.from_numpy(x)
        w = x.shape[-1] // n
        return x[..., rank * w:(rank + 1) * w].contiguous()
    out = {}
    for reverse in (False, True):
        with torch.no_grad():
            out["scan", reverse] = sequence_parallel_scan(
                part(scan["a"]), part(scan["b"]), reverse=reverse).numpy()
        a = part(grad["a"]).requires_grad_()
        b = part(grad["b"]).requires_grad_()
        with mesh.watch_collectives() as calls:
            (sequence_parallel_scan(a, b, reverse=reverse)
             * part(grad["ct"])).sum().backward()
        out["grad", reverse] = a.grad.numpy(), b.grad.numpy()
        out["calls", reverse] = calls
    with torch.no_grad():
        out["sp"] = selective_scan_sp(
            part(sp["u"]), part(sp["delta"]), torch.from_numpy(sp["A"]),
            part(sp["B"]), part(sp["C"]), torch.from_numpy(sp["D"]),
            torch.from_numpy(sp["bias"]), delta_softplus=True).numpy()
    xs = [part(sp_grad[k]).requires_grad_() for k in ("u", "delta", "B", "C")]
    y = selective_scan_sp(xs[0], xs[1], torch.from_numpy(sp_grad["A"]),
                          xs[2], xs[3], delta_softplus=True, reverse=True)
    (y.float() ** 2).sum().backward()
    out["sp_grad"] = [x.grad.numpy() for x in xs]
    return out
